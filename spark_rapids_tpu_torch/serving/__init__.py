"""serving: the multi-tenant query lifecycle layer.

* :mod:`.query_context` — per-query lifecycle state: a ``QueryContext``
  carries the cancel token, the optional deadline and the per-query
  transient-retry budget, bound to the executing thread. Cooperative
  ``checkpoint()`` calls sit at the task boundaries that already exist
  (partition-task start in the executor loop, batch pull in
  ``execs/base.py``, exchange map task in ``shuffle/exchange.py``).
* :mod:`.scheduler` — the process-wide ``QueryScheduler`` (admission,
  SLO classes, shedding, the plan cache) plus the executor that every
  ``collect()`` reaches (:func:`~.scheduler.execute_plan`).

``query_context`` stays import-light (no engine imports at module scope):
``execs/base.py`` imports it at module load, and the scheduler — which does
import the exec layer — is only pulled in lazily by the session.
"""

from .query_context import (QueryCancelledError, QueryContext,
                            QueryDeadlineExceeded, QueryQueueFull, bind,
                            checkpoint, consume_retry_budget, current)

__all__ = [
    "QueryCancelledError", "QueryContext", "QueryDeadlineExceeded",
    "QueryQueueFull", "bind", "checkpoint", "consume_retry_budget",
    "current",
]
