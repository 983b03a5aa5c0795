"""Q1 kernel level of the PyTorch port held against the JAX reference.

The reference Pallas kernels cannot run on this JAX (no ``jax.enable_x64``
scope; see test_q1_kernels.py), so the port's plain versions of both Hopper
kernels, and its ``q1_step``, are held against the reference ``q1_step`` —
the same math through XLA — and the numpy oracle. Tolerance: rtol 1e-4 as
tests/test_q1_kernels.py uses (f32 sums in different orders); counts exact.
The kernels themselves are held against these plain versions on the card
by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_tpu.kernels import q1 as ref_q1
from spark_rapids_tpu_torch.entry import entry
from spark_rapids_tpu_torch.kernels import q1 as port_q1
from spark_rapids_tpu_torch.kernels import q1_cuda

SIZES = [100, 12345, 1 << 15, 1 << 16]


def _ref_batch(n, seed, mask_every=None):
    batch, cutoff = ref_q1.make_example_batch(n, seed=seed)
    if mask_every:
        valid = np.ones(n, bool)
        valid[::mask_every] = False
        batch = batch._replace(valid=jnp.asarray(valid))
    return batch, cutoff


def _to_port(batch):
    return port_q1.q1_inputs_from_numpy(
        {k: np.asarray(v) for k, v in batch._asdict().items()}, "cpu")


def _assert_step_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        g = got[k].numpy()
        w = np.asarray(want[k])
        assert g.dtype == w.dtype, k
        if k == "count_order":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-4)


@pytest.mark.parametrize("n", [100, 12345, 1 << 15])
def test_example_batch_is_byte_identical(n):
    ref, ref_cut = ref_q1.make_example_batch(n, seed=5)
    port, port_cut = port_q1.make_example_batch(n, seed=5, device="cpu")
    assert ref_cut == port_cut
    for k, v in ref._asdict().items():
        want = np.asarray(v)
        got = getattr(port, k).numpy()
        assert got.dtype == want.dtype, k
        assert got.tobytes() == want.tobytes(), k


@pytest.mark.parametrize("mask_every", [None, 3])
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("step", [port_q1.q1_step, q1_cuda.q1_step_simt,
                                  q1_cuda.q1_step_mma],
                         ids=["plain", "simt_plain", "mma_plain"])
def test_step_matches_reference(step, n, mask_every):
    batch, cutoff = _ref_batch(n, seed=7, mask_every=mask_every)
    want = ref_q1.q1_step(batch, jnp.int32(cutoff))
    got = step(_to_port(batch), cutoff)
    _assert_step_equal(got, want)
    oracle = ref_q1.q1_reference_numpy(jax.tree.map(np.asarray, batch),
                                       int(cutoff))
    np.testing.assert_array_equal(got["count_order"].numpy(),
                                  oracle["count_order"])
    for k in ("sum_qty", "sum_base_price", "sum_disc_price", "sum_charge"):
        np.testing.assert_allclose(got[k].numpy().astype(np.float64),
                                   oracle[k], rtol=1e-4)


def test_port_oracle_matches_reference_oracle():
    batch, cutoff = _ref_batch(12345, seed=2, mask_every=3)
    want = ref_q1.q1_reference_numpy(jax.tree.map(np.asarray, batch),
                                     int(cutoff))
    got = port_q1.q1_reference_numpy(_to_port(batch), int(cutoff))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_best_step_on_cpu_is_plain_and_launches_nothing():
    q1_cuda.reset_launch_counts()
    step = q1_cuda.q1_step_best("cpu")
    assert step is port_q1.q1_step
    batch, cutoff = port_q1.make_example_batch(1 << 12, device="cpu")
    out = step(batch, cutoff)
    assert int(out["count_order"].sum()) > 0
    # the wrappers on CPU tensors run their plain versions, uncounted
    q1_cuda.q1_agg_simt(batch, cutoff)
    q1_cuda.q1_agg_mma(batch, cutoff)
    assert q1_cuda.launches == {"q1_agg_simt": 0, "q1_agg_mma": 0}


def test_entry_on_cpu_matches_reference_entry_shape():
    step, (batch, cutoff) = entry("cpu")
    assert batch.quantity.shape == (1 << 16,)
    assert batch.quantity.device.type == "cpu"
    out = step(batch, cutoff)
    assert out["count_order"].dtype == torch.int32
    assert out["sum_qty"].dtype == torch.float32


def test_wrapper_rejects_mixed_inputs():
    batch, cutoff = port_q1.make_example_batch(64, device="cpu")
    bad = batch._replace(quantity=batch.quantity.to(torch.float64))
    with pytest.raises(TypeError):
        q1_cuda._check(bad)
    bad = batch._replace(tax=batch.tax[:32])
    with pytest.raises(ValueError):
        q1_cuda._check(bad)


# --- q1_agg_simt's launch plan (the host half of the kernel) ---------------

_BASE = 0x7F0000000000  # 256-byte aligned, as the caching allocator gives
_PLAN_OFFSETS = {  # element offset of each column (7 words, then valid)
    "aligned": (0,) * 8,
    "all_1": (1,) * 8,
    "all_2": (2,) * 8,
    "all_3": (3,) * 8,
    "mixed": (0, 1, 2, 3, 1, 2, 3, 0),
    "valid_only": (0,) * 7 + (1,),
}


def _plan_ptrs(offsets):
    words = [_BASE + (c << 20) + 4 * o for c, o in enumerate(offsets[:7])]
    return words, _BASE + (7 << 20) + offsets[7]


@pytest.mark.parametrize("offsets", list(_PLAN_OFFSETS.values()),
                         ids=list(_PLAN_OFFSETS))
@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 4095, 12345, (1 << 16) + 3])
def test_simt_plan_covers_rows_once(n, offsets):
    words, valid = _plan_ptrs(offsets)
    plan = q1_cuda.simt_plan(n, words, valid, sms=132, blocks_per_sm=2,
                             threads=256)
    assert plan.head >= 0 and plan.body >= 0 and plan.tail >= 0
    assert plan.head + plan.body + plan.tail == n
    assert plan.body % 4 == 0
    # the rows the kernel's two loops visit, as csrc/q1_agg.cu walks them
    vector = (plan.head + 4 * np.arange(plan.body // 4)[:, None]
              + np.arange(4)).ravel()
    j = np.arange(n - plan.body)
    scalar = np.where(j < plan.head, j, j + plan.body)
    rows = np.concatenate([vector, scalar])
    assert rows.size == n
    np.testing.assert_array_equal(np.bincount(rows, minlength=n),
                                  np.ones(n, np.int64))
    if plan.body:
        assert all((p + 4 * plan.head) % 16 == 0 for p in words)
        assert (valid + plan.head) % 4 == 0
    if len(set(offsets)) == 1:  # one shared alignment: vectors past 3 rows
        assert plan.head <= 3 and plan.tail <= 3
    else:
        assert plan.body == 0
    work = max(plan.body // 4, n - plan.body)
    assert 1 <= plan.blocks <= 132 * 2
    assert plan.blocks * 256 >= work or plan.blocks == 132 * 2


def test_simt_plan_grid_is_one_resident_wave():
    words, valid = _plan_ptrs(_PLAN_OFFSETS["aligned"])
    big = q1_cuda.simt_plan(1 << 24, words, valid, sms=132, blocks_per_sm=2,
                            threads=256)
    assert big == q1_cuda.SimtPlan(head=0, body=1 << 24, tail=0, blocks=264)
    small = q1_cuda.simt_plan(4096, words, valid, sms=132, blocks_per_sm=2,
                              threads=256)
    assert small.blocks == 4  # 1024 quads, 256 a block
    # a column one element off the others sends every row to the scalar loop
    odd = q1_cuda.simt_plan(100, [words[0] + 4] + words[1:], valid, sms=132,
                            blocks_per_sm=2, threads=256)
    assert (odd.head, odd.body, odd.tail, odd.blocks) == (100, 0, 0, 1)


@pytest.mark.parametrize("offsets", [(1,) * 8, (2,) * 8, (3,) * 8,
                                     (0, 1, 2, 3, 1, 2, 3, 0)],
                         ids=["all_1", "all_2", "all_3", "mixed"])
def test_simt_on_sliced_columns_matches_reference(offsets):
    n = 12345
    full, cutoff = _ref_batch(n + 3, seed=11, mask_every=3)
    sliced = {k: np.asarray(v)[o:o + n]
              for (k, v), o in zip(full._asdict().items(), offsets)}
    want = ref_q1.q1_step(ref_q1.Q1Inputs(**{k: jnp.asarray(v)
                                            for k, v in sliced.items()}),
                          jnp.int32(cutoff))
    port_full = _to_port(full)
    port = port_q1.Q1Inputs(*(t[o:o + n] for t, o in zip(port_full, offsets)))
    assert all(t.is_contiguous() for t in port)
    assert port.quantity.data_ptr() != port_full.quantity.data_ptr()
    _assert_step_equal(q1_cuda.q1_step_simt(port, cutoff), want)
