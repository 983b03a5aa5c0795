"""The port's chaos injector held against the JAX reference: one seed and
site list pick the same injections in both packages — the same trace
records (site, sequence number, kind, detail, forced), the same byte
offsets mangled, and the same exception kinds raised — because each site
draws from its own stream seeded by sha256(seed, site)."""

import pytest

from spark_rapids_tpu.chaos import injector as ref_inj
from spark_rapids_tpu.config import RapidsConf as RefConf
from spark_rapids_tpu_torch.chaos import injector as port_inj
from spark_rapids_tpu_torch.config import RapidsConf

PKGS = {"ref": (ref_inj, RefConf), "port": (port_inj, RapidsConf)}

SITES = ("hbm.alloc", "spill.to_host", "spill.to_disk", "device.dispatch",
         "sched.admit", "query.cancel", "sched.shed", "scan.read")


def _conf(seed, sites, kinds="", prob="0.3", max_inj="0"):
    return {"spark.rapids.tpu.test.chaos.enabled": "true",
            "spark.rapids.tpu.test.chaos.seed": str(seed),
            "spark.rapids.tpu.test.chaos.sites": ",".join(sites),
            "spark.rapids.tpu.test.chaos.kinds": kinds,
            "spark.rapids.tpu.test.chaos.probability": prob,
            "spark.rapids.tpu.test.chaos.maxInjections": max_inj,
            "spark.rapids.tpu.test.chaos.latencyMs": "0.01"}


def _drive(pkg, settings, visits=40, forced=()):
    """Visit every site `visits` times (alternating in and out of a retry
    scope, splittable and not), mangle a byte stream at each byte site,
    and record what each visit raised."""
    mod, conf_cls = PKGS[pkg]
    inj = mod.FaultInjector.configure(conf_cls(settings))
    for site, kind, n in forced:
        inj.force(site, kind, n)
    outcomes = []
    data = bytes(range(256)) * 4
    for i in range(visits):
        for site in SITES:
            scope = i % 3
            try:
                if scope == 0:
                    mod.inject(site, detail=f"v{i}")
                else:
                    with mod.retry_scope(splittable=scope == 1):
                        mod.inject(site, detail=f"v{i}")
                got = None
            except BaseException as e:  # noqa: BLE001 — recorded
                got = type(e).__name__.replace("Tpu", "").replace(
                    "Torch", "")
            outcomes.append((site, i, got))
            if site in ("spill.to_disk", "scan.read"):
                out = mod.corrupt_bytes(site, data)
                outcomes.append((site, i, len(out),
                                 out == data, sum(out) % 65521))
    trace = inj.trace()
    mod.FaultInjector.reset_for_tests()
    return trace, outcomes


CASES = {
    "all_kinds_seed7": (_conf(7, SITES), ()),
    "oom_kinds_seed11": (_conf(11, SITES, "retry_oom,split_oom"), ()),
    "bytes_seed3": (_conf(3, SITES, "corrupt,truncate,io_error",
                          prob="0.5"), ()),
    "capped_seed5": (_conf(5, SITES, prob="0.9", max_inj="17"), ()),
    "forced_over_random": (_conf(2, ("hbm.alloc",), "retry_oom",
                                 prob="0.2"),
                           (("hbm.alloc", "split_oom", 3),
                            ("spill.to_disk", "corrupt", 2))),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_same_seed_same_injections(case):
    settings, forced = CASES[case]
    want = _drive("ref", settings, forced=forced)
    got = _drive("port", settings, forced=forced)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[0], "the case injected nothing"


def test_trace_text_is_identical():
    settings, _ = CASES["all_kinds_seed7"]
    texts = []
    for pkg in ("ref", "port"):
        mod, conf_cls = PKGS[pkg]
        inj = mod.FaultInjector.configure(conf_cls(settings))
        for i in range(25):
            for site in SITES:
                try:
                    with mod.retry_scope():
                        mod.inject(site)
                except BaseException:  # noqa: BLE001
                    pass
        texts.append(inj.trace_text())
        mod.FaultInjector.reset_for_tests()
    assert texts[0] == texts[1] and texts[0]


@pytest.mark.parametrize("seed", [0, 1, 12345])
def test_site_seeds_match(seed):
    for site in port_inj.ALL_SITES:
        assert port_inj._site_seed(seed, site) == \
            ref_inj._site_seed(seed, site)
    assert port_inj.ALL_SITES == ref_inj.ALL_SITES
    assert port_inj.SITE_KINDS == ref_inj.SITE_KINDS
