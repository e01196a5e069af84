"""The port's hardware target and I/O model against the reference's.

A target built from the reference's ``V5E`` fields makes the port's
solver, quanta and Q volumes reproduce the reference's exactly (the
cases of ``tests/test_io_model.py`` plus seeded shapes); the ``h100``
target carries the data-sheet constants and WGMMA's quanta.  Every
comparison is exact (``==``) unless it states a tolerance.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hardware as jhw
from repro.core import io_model as jio
from repro_torch.core import hardware as thw
from repro_torch.core import io_model as tio

V5E = jhw.V5E
DTYPES = ["bfloat16", "float32", "int8"]
JDT = {name: jnp.dtype(name) for name in DTYPES}
TDT = {"bfloat16": torch.bfloat16, "float32": torch.float32,
       "int8": torch.int8}


def tpu_target(ref=V5E) -> thw.HopperTarget:
    """A port target holding the reference target's own fields: S is its
    VMEM, the (sublane, lane) tiling packs along m, k steps by the lane,
    tiles are solved (no route tiles) and n is capped only by the
    solver."""
    return thw.HopperTarget(
        name=ref.name, card=ref.name,
        peak_flops_bf16=ref.peak_flops_bf16,
        peak_flops_fp32=ref.peak_flops_fp32,
        peak_flops_int8=ref.peak_flops_int8,
        fast_bytes=ref.vmem_bytes, hbm_bytes=ref.hbm_bytes,
        hbm_bandwidth=ref.hbm_bandwidth, quantum_m=ref.sublane,
        quantum_n=ref.lane, quantum_k=ref.lane, packed_axis="m", max_n=0,
        route_tiles=False)


TPU = tpu_target()

# Seeded shapes for the solver: the hypothesis ranges of
# tests/test_io_model.py::test_solver_properties, drawn once.
_R = np.random.RandomState(24)
SOLVER_CASES = [(int(_R.randint(128, 1 << 15)), int(_R.randint(128, 1 << 15)),
                 int(_R.randint(128, 1 << 15)), DTYPES[i % 3])
                for i in range(18)]
SMALL_CASES = [(1, 2048, 2048), (37, 1024, 1024), (8, 128, 64),
               (6, 512, 64), (1000, 5632, 2048), (4096, 4096, 4096)]


def _fields(t):
    return dataclasses.asdict(t)


def test_h100_constants_are_the_data_sheet():
    h = thw.H100
    assert h.name == "h100" and thw.get_target("h100") is h
    assert "NVIDIA H100 80GB HBM3, 700 W" == h.card
    assert (h.peak_flops_bf16, h.peak_flops_int8, h.peak_flops_fp32) == (
        989e12, 1979e12, 67e12)
    assert (h.hbm_bytes, h.hbm_bandwidth) == (80 * 10 ** 9, 3.35e12)
    assert h.smem_per_block == 227 * 1024 and h.sms == 132
    # S = the register accumulator plus the SMEM ring.
    assert h.fast_bytes == h.acc_register_bytes + h.smem_per_block
    assert h.peak_flops(torch.bfloat16) == 989e12
    assert h.peak_flops(torch.int8) == 1979e12
    assert h.peak_flops(torch.float32) == 67e12
    assert h.peak_flops("int8") == 1979e12


@pytest.mark.parametrize("dt, want", [("float32", (64, 8, 8)),
                                      ("bfloat16", (64, 8, 16)),
                                      ("int8", (64, 8, 32))])
def test_h100_wgmma_quanta(dt, want):
    assert thw.H100.tile_quantum(TDT[dt]) == want
    assert tio.vmem_quantum(TDT[dt]) == want[:2]
    assert thw.H100.max_n == 256


def test_h100_solver_respects_wgmma_quanta_and_n_cap():
    t = tio.solve_tile_config(4096, 4096, 4096, dtype_in=torch.bfloat16)
    assert t.bm % 64 == 0 and t.bn % 8 == 0 and t.bn <= 256
    assert t.bk % 16 == 0
    assert t.vmem_bytes <= 0.75 * thw.H100.fast_bytes


@pytest.mark.parametrize("dt", DTYPES)
def test_quantum_packing_matches_reference(dt):
    assert tio.vmem_quantum(TDT[dt], TPU) == jio.vmem_quantum(JDT[dt], V5E)
    assert TPU.peak_flops(TDT[dt]) == V5E.peak_flops(JDT[dt])


def test_paper_equations_match_reference():
    assert tio.computational_intensity(512, 512) == \
        jio.computational_intensity(512, 512)
    m = n = k = 4096
    assert tio.io_volume_elements(m, n, k, 512, 512) == m * n * (
        1 + k * (2 / 512))
    s_words = V5E.vmem_bytes // 4
    assert tio.io_lower_bound_elements(8192, 8192, 8192, s_words) == \
        jio.io_lower_bound_elements(8192, 8192, 8192, s_words)
    for bk, it in ((256, 2), (128, 2), (128, 4), (64, 1)):
        assert tio.burst_penalty(bk, it) == jio.burst_penalty(bk, it)
        assert tio.effective_intensity(1024, 512, bk, it) == \
            jio.effective_intensity(1024, 512, bk, it)
    assert tio.drain_overhead_fraction(512, 512, 512, 8, 128) == \
        jio.drain_overhead_fraction(512, 512, 512, 8, 128)
    assert tio.arithmetic_intensity_ops_per_byte(256, 512, 2) == \
        jio.arithmetic_intensity_ops_per_byte(256, 512, 2)


@pytest.mark.parametrize("m, n, k, dt", SOLVER_CASES)
def test_solver_tile_choice_matches_reference(m, n, k, dt):
    want = jio.solve_tile_config(m, n, k, dtype_in=JDT[dt], hw=V5E)
    got = tio.solve_tile_config(m, n, k, dtype_in=TDT[dt], hw=TPU)
    assert _fields(got) == _fields(want)
    # and the reference test's properties hold for the port's answer
    qm, qn = tio.vmem_quantum(TDT[dt], TPU)
    assert got.bm % qm == 0 and got.bn % qn == 0 and got.bk % 128 == 0
    assert got.vmem_bytes == tio.tile_vmem_bytes(
        got.bm, got.bn, got.bk, TDT[dt].itemsize, 4)


@pytest.mark.parametrize("m, n, k", SMALL_CASES)
@pytest.mark.parametrize("mixed", ["none", "w8", "w8a8"])
def test_solver_small_and_mixed_shapes_match_reference(m, n, k, mixed):
    kw_j = {"w8": dict(dtype_b=jnp.int8),
            "w8a8": dict(dtype_b=jnp.int8, dtype_a=jnp.int8)}.get(mixed, {})
    kw_t = {"w8": dict(dtype_b=torch.int8),
            "w8a8": dict(dtype_b=torch.int8, dtype_a=torch.int8)}.get(
                mixed, {})
    want = jio.solve_tile_config(m, n, k, dtype_in=jnp.bfloat16, hw=V5E,
                                 **kw_j)
    got = tio.solve_tile_config(m, n, k, dtype_in=torch.bfloat16, hw=TPU,
                                **kw_t)
    assert _fields(got) == _fields(want)


def test_solver_reference_cases():
    """tests/test_io_model.py's named cases: square when unconstrained,
    the drain separation's ~sqrt(2), burst-aware bk — same answers."""
    for db in (False, True):
        want = jio.solve_tile_config(1 << 15, 1 << 15, 1 << 15,
                                     dtype_in=jnp.float32,
                                     double_buffer_out=db)
        got = tio.solve_tile_config(1 << 15, 1 << 15, 1 << 15,
                                    dtype_in=torch.float32, hw=TPU,
                                    double_buffer_out=db)
        assert _fields(got) == _fields(want)
    sq = tio.solve_tile_config(1 << 16, 1 << 16, 1 << 16,
                               dtype_in=torch.float32, hw=TPU)
    assert 0.5 <= sq.bm / sq.bn <= 2.0
    ours = tio.solve_tile_config(1 << 15, 1 << 15, 1 << 15,
                                 dtype_in=torch.float32, hw=TPU)
    db = tio.solve_tile_config(1 << 15, 1 << 15, 1 << 15,
                               dtype_in=torch.float32, hw=TPU,
                               double_buffer_out=True)
    assert ours.intensity / db.intensity > 1.15
    for dt, it in (("bfloat16", 2), ("int8", 1)):
        t = tio.solve_tile_config(16384, 16384, 16384, dtype_in=TDT[dt],
                                  hw=TPU)
        assert t.bk * it >= 512
        assert _fields(t) == _fields(jio.solve_tile_config(
            16384, 16384, 16384, dtype_in=JDT[dt], hw=V5E))


_QR = np.random.RandomState(7)
Q_CASES = [tuple(int(v) for v in _QR.randint(1, 5000, 5)) for _ in range(8)]


@pytest.mark.parametrize("m, n, k, x, y", Q_CASES)
def test_q_volumes_match_reference(m, n, k, x, y):
    assert tio.io_volume_elements(m, n, k, x, y) == \
        jio.io_volume_elements(m, n, k, x, y)
    for ia, ib, io in ((2, 2, None), (2, 1, 2), (1, 1, 2), (4, 1, 4)):
        assert tio.io_volume_bytes(m, n, k, x, y, a_itemsize=ia,
                                   b_itemsize=ib, out_itemsize=io) == \
            jio.io_volume_bytes(m, n, k, x, y, a_itemsize=ia,
                                b_itemsize=ib, out_itemsize=io)
    for kw in (dict(), dict(n_b=2), dict(n_b=2, n_out=1,
                                        prologue_vec_elements=m + k),
               dict(prologue_mk_ops=1), dict(prologue_kn_ops=1)):
        assert tio.io_volume_elements_program(m, n, k, x, y, **kw) == \
            jio.io_volume_elements_program(m, n, k, x, y, **kw)
    assert tio.two_pass_glu_q_elements(m, n, k, x, y) == \
        jio.two_pass_glu_q_elements(m, n, k, x, y)
    for kw in (dict(), dict(n_stream_mn=2, has_bias=True),
               dict(fused=False), dict(scale_a_elements=m,
                                       scale_b_elements=n)):
        assert tio.epilogue_q_elements(m, n, **kw) == \
            jio.epilogue_q_elements(m, n, **kw)
    for kw in (dict(), dict(epilogue_mn_ops=1, epilogue_bias=True),
               dict(n_b=2, itemsize_b=1), dict(prologue_mk_ops=1,
                                               itemsize_a=1),
               dict(double_buffer_out=True, prologue_kn_ops=1)):
        assert tio.tile_vmem_bytes(x, y, 128, 2, 4, **kw) == \
            jio.tile_vmem_bytes(x, y, 128, 2, 4, **kw)


@pytest.mark.parametrize("dt", DTYPES)
def test_roofline_matches_reference(dt):
    want_t = jio.solve_tile_config(2048, 4096, 1024, dtype_in=JDT[dt])
    got_t = tio.solve_tile_config(2048, 4096, 1024, dtype_in=TDT[dt],
                                  hw=TPU)
    want = jio.gemm_roofline(2048, 4096, 1024, want_t, JDT[dt], V5E)
    got = tio.gemm_roofline(2048, 4096, 1024, got_t, TDT[dt], TPU)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert tio.memory_utilization(256, 512, 128, 2, 4, TPU) == \
        jio.memory_utilization(256, 512, 128, 2, 4, V5E)
