"""The port's MoE layer (``repro_torch.models.moe``) against
``repro.models.moe`` in fp32 on the reduced MoE configs, with the
reference's parameters: the routing itself (expert ids, positions in the
capacity buffer, keep mask, and the scattered buffer the expert GEMMs
read) exactly, the output at 1e-4 and the aux loss at 1e-6."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.models import model as JM
from repro.models import moe as jmoe
from repro_torch.configs import get_reduced
from repro_torch.models import moe as tmoe

# (capacity_factor, B, L): 0.5 drops rows, 50 drops none, and a batch of
# single tokens takes the decode branch (one group across the batch).
CASES = {"drops": (0.5, 2, 64), "dropless": (50.0, 2, 37),
         "batched_decode": (1.25, 5, 1)}


def _with_cf(cfg, cf):
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


def _setup(arch, case):
    cf, B, L = CASES[case]
    jcfg, cfg = _with_cf(jax_reduced(arch), cf), _with_cf(get_reduced(arch), cf)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(3))
    pre = "blocks/moe/"
    jsub = {k[len(pre):]: v[0] for k, v in jp.items() if k.startswith(pre)}
    tsub = {k: torch.as_tensor(np.array(v)) for k, v in jsub.items()}
    r = np.random.RandomState(11)
    x = r.randn(B, L, cfg.d_model).astype(np.float32)
    res = r.randn(B, L, cfg.d_model).astype(np.float32)
    return jcfg, cfg, jsub, tsub, x, res


def _reference_routing(jsub, x, jcfg):
    """The reference's routing lines (``repro/models/moe.py:80-104``) on
    the group the layer routes: ids, positions and the keep mask."""
    mo = jcfg.moe
    B0, L0, d = x.shape
    if L0 == 1 and B0 > 1:
        x = x.reshape(1, B0, d)
    B, L, _ = x.shape
    logits = jnp.einsum("bld,de->ble", jnp.asarray(x, jnp.float32),
                        jsub["router"].astype(jnp.float32))
    probs = jax.nn.softmax(logits, axis=-1)
    _, top_i = jax.lax.top_k(probs, mo.top_k)
    cap = tmoe.capacity(jcfg, L)
    idx = top_i.reshape(B, L * mo.top_k)
    oh = jax.nn.one_hot(idx, mo.n_experts, dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(oh, axis=1), idx[..., None],
                              axis=2)[..., 0] - 1
    return np.asarray(probs), np.asarray(idx), np.asarray(pos), cap


def _near_tie(probs, k):
    """The smallest gap between the k-th and (k+1)-th probability of any
    token: a flipped choice there is a tie, not a fault of the port."""
    s = -np.sort(-probs.reshape(-1, probs.shape[-1]), axis=-1)
    return float((s[:, k - 1] - s[:, k]).min())


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "mixtral-8x7b"])
def test_moe_apply_matches_reference(arch, case, monkeypatch):
    jcfg, cfg, jsub, tsub, x, res = _setup(arch, case)
    seen = {}

    def capture(name, fn):
        def wrapped(xe, *a, **kw):
            seen[name] = np.asarray(xe)
            return fn(xe, *a, **kw)
        return wrapped

    monkeypatch.setattr(jmoe, "ca_expert_glu_matmul",
                        capture("jax", jmoe.ca_expert_glu_matmul))
    monkeypatch.setattr(tmoe, "ca_expert_glu_matmul",
                        capture("torch", tmoe.ca_expert_glu_matmul))
    want, jaux = jmoe.moe_apply(jsub, jnp.asarray(x), jcfg,
                                residual=jnp.asarray(res))
    got, aux = tmoe.moe_apply(tsub, torch.as_tensor(x), cfg,
                              residual=torch.as_tensor(res))

    # Routing: the ids, positions and keep mask, then the buffer itself.
    probs, jidx, jpos, cap = _reference_routing(jsub, x, jcfg)
    xg = torch.as_tensor(x).reshape(1, -1, cfg.d_model) \
        if case == "batched_decode" else torch.as_tensor(x)
    top_i, _, _ = tmoe.route(xg, tsub["router"], cfg)
    idx, dest, keep = tmoe.dispatch(top_i, cfg.moe.n_experts, cap)
    gap = _near_tie(probs, cfg.moe.top_k)
    assert np.array_equal(idx.numpy(), jidx), \
        f"expert choice differs; nearest tie between choices k and k+1: {gap:.3e}"
    np.testing.assert_array_equal(dest.numpy(), np.where(jpos < cap, jpos,
                                                         cap))
    np.testing.assert_array_equal(keep.numpy(), jpos < cap)
    if case == "drops":
        assert not keep.all()
    else:
        assert keep.all()
    np.testing.assert_array_equal(seen["torch"], seen["jax"])

    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6,
                               atol=1e-6)


def test_capacity_matches_reference_formula():
    cfg = get_reduced("deepseek-v2-lite-16b")
    full = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=64, top_k=6))
    # One decode token, a 37-token and a 128-token prompt at cf 1.25.
    assert [tmoe.capacity(full, L) for L in (1, 37, 128)] == [8, 8, 16]
