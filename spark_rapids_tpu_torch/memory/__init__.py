"""The memory runtime: the device budget (``hbm``), the device semaphore
(``semaphore``), the spill catalog (``spill``), the retry framework
(``retry``) and the leak registry (``cleaner``)."""
