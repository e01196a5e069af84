"""The CUDA CA-GEMM kernel against its plain version, on a card.

Imports neither JAX nor ``repro``, so it runs on a GPU host without JAX:
``PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
Without a card every case skips with its reason.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ca_mmm as K
from repro_torch.kernels.program import program_from_tag, rms_row_scale

TAGS = ["none", "res", "rms>glu.silu(none|none)", "bias+gelu+mul+res",
        "glu.gelu(bias|bias)"]


def _program_inputs(tag, m, n, k, dtype, seed):
    r = np.random.RandomState(seed)
    t = lambda *shape, dt=dtype: torch.as_tensor(  # noqa: E731
        r.randn(*shape)).to(device="cuda", dtype=dt)
    spec = program_from_tag(tag)
    a = t(m, k)
    bs = [t(k, n) / np.sqrt(k) for _ in range(spec.n_b)]
    kw = {}
    if spec.prologue.kind == "rms":
        kw["gain"] = t(k, dt=torch.float32).abs() + 0.5
        kw["row_scale"] = rms_row_scale(a, 1e-5)
    ops = []
    for b in spec.branches:
        d = {}
        if b.has_bias:
            d["bias"] = t(n)
        if b.has_mul:
            d["mul"] = t(m, n)
        if b.has_residual:
            d["residual"] = t(m, n)
        ops.append(d)
    return a, bs, dict(spec=spec, branch_operands=ops, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,m,n,k", [(torch.float32, 5, 200, 300),
                                         (torch.bfloat16, 37, 203, 301)])
@pytest.mark.parametrize("tag", TAGS)
def test_cuda_kernel_matches_plain_version(tag, dtype, m, n, k):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    a, bs, kw = _program_inputs(tag, m, n, k, dtype, seed=7)
    K.reset_launch_counts()
    got = K.ca_gemm_program(a, bs, **kw)
    assert K.launch_counts == {tag: 1}
    want = K.ca_gemm_program_reference(a, bs, **kw)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    # fp32: the sums run in another order; bf16: one output ulp may flip.
    scale = want.float().abs().max().item()
    tol = 1e-4 * (1 + scale) if dtype == torch.float32 else 2e-2 * scale
    assert err <= tol, (err, tol)
