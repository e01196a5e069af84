"""Training every family in the port against the reference on the CPU
(plain versions, reduced configs): the MoE archs (deepseek-v2-lite-16b,
mixtral-8x7b), MLA (deepseek, minicpm3-4b with q-LoRA), the Mamba2 stack
(mamba2-370m), zamba2's hybrid (zamba2-7b), M-RoPE over the ``embeds``
frontend (qwen2-vl-72b) and the codebook heads (musicgen-large).

The loss, the aux loss and every gradient leaf of ``train.step.loss_fn``
against ``jax.value_and_grad`` of the reference's, on the reference's
``init_params`` carried across as fp32 masters; the SSD scan's masked
backward where the reference's is NaN; the capacity scatter's gradient;
remat, microbatches, the launcher with checkpoints, the K1 programs of a
step against ``chip_smoke.py``'s formula, and the tile plans the train
step warms up against the reference's."""

import dataclasses
import importlib.util
import inspect
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_isolation import isolated_port_state  # noqa: F401  (autouse)
from repro.configs import get_reduced as jax_reduced
from repro.core.gemm import gemm_mode
from repro.data import pipeline as jdata
from repro.models import model as JM
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.train import step as JT
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_reduced, list_archs
from repro_torch.data.pipeline import DataConfig, batch_for_model
from repro_torch.kernels import ca_mmm as K
from repro_torch.launch.train import run_training
from repro_torch.models import model as M
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.optim import adamw
from repro_torch.train import step as T
from test_torch_moe import _setup

# The seven configurations that train since the dense GQA family.
NEW_ARCHS = ["deepseek-v2-lite-16b", "minicpm3-4b", "mixtral-8x7b",
             "mamba2-370m", "zamba2-7b", "qwen2-vl-72b", "musicgen-large"]


def _smoke():
    """``chip_smoke.py`` as a module, for its per-family launch formula."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _loss_and_grads(arch: str, dtype: str, reference_mode: str = "xla"):
    """loss_fn's loss, aux and per-leaf gradients, port and reference, on
    the same params (the reference's init as fp32 masters, cast to
    ``dtype`` as ``build_train_step`` casts them) and the same batch of
    ``batch_for_model`` (4 x 16 tokens, or embeddings and codebook
    labels).  ``reference_mode`` is the reference's GEMM dispatch mode."""
    jcfg, tcfg = jax_reduced(arch, dtype), get_reduced(arch, dtype)
    masters = {k: np.asarray(v) for k, v in
               JM.init_params(jcfg, jax.random.PRNGKey(0)).items()}
    batch = jdata.batch_for_model(jcfg, jdata.DataConfig(
        vocab_size=jcfg.vocab_size, seq_len=16, global_batch=4), 0)
    jp = {k: jnp.asarray(v, jcfg.dtype() if v.ndim >= 2 else jnp.float32)
          for k, v in masters.items()}
    with gemm_mode(reference_mode):
        (_, jm), jgr = jax.jit(jax.value_and_grad(JT.loss_fn, has_aux=True),
                               static_argnums=2)(
            jp, JT.cast_batch(batch, jcfg), jcfg)
    tp = T.cast_params(M.params_from_jax(masters, tcfg, device="cpu",
                                         masters=True), tcfg)
    total, tm = T.loss_fn(tp, T.cast_batch(batch, tcfg, "cpu"), tcfg)
    keys = sorted(tp)
    grads = torch.autograd.grad(total, [tp[k] for k in keys])
    return ({"loss": (tm["loss"].item(), float(jm["loss"])),
             "aux": (tm["aux"].item(), float(jm["aux"]))},
            {k: (g.float().numpy(), np.asarray(jgr[k], np.float32))
             for k, g in zip(keys, grads)}, jcfg, masters, batch)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_loss_aux_and_grads_match_reference_fp32(arch):
    """fp32: the same arithmetic up to summation order (every leaf within
    1e-4 of its largest reference entry, the loss within 1e-5, the aux
    within 1e-6), each config at its own capacity factor."""
    metrics, grads, jcfg, masters, batch = _loss_and_grads(arch, "float32")
    (loss, jloss), (aux, jaux) = metrics["loss"], metrics["aux"]
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    np.testing.assert_allclose(aux, jaux, rtol=1e-6, atol=1e-7)
    assert (jaux != 0.0) == (jcfg.moe is not None and jcfg.moe.n_experts > 0)
    assert set(grads) == set(M.model_defs(get_reduced(arch)))
    for k, (g, w) in grads.items():
        err, ref = np.abs(g - w).max(), np.abs(w).max()
        assert err <= 1e-4 * ref, (k, err, ref)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "mamba2-370m"])
def test_loss_and_grads_match_reference_bf16(arch):
    """bf16 compute: both round every GEMM output and weight to bf16, but
    at other places in the backward (the port rounds each cotangent to
    bf16 before its K1f GEMM, as the reference's kernel VJP does), so the
    loss is held at rtol 1e-3 and each gradient leaf at a relative L2
    error of 3e-2, about four bf16 ulps (2^-8 each), the bound
    ``tests/test_torch_train.py`` holds stablelm to (worst leaves seen
    here: 9.5e-3 deepseek, 7.4e-3 mamba2).  deepseek's reference runs its
    kernel path in interpret mode: this CPU's XLA refuses the batched
    expert einsum of bf16 operands into fp32 that its XLA mode takes."""
    mode = "interpret" if arch.startswith("deepseek") else "xla"
    metrics, grads, *_ = _loss_and_grads(arch, "bfloat16", mode)
    (loss, jloss), (aux, jaux) = metrics["loss"], metrics["aux"]
    np.testing.assert_allclose(loss, jloss, rtol=1e-3)
    np.testing.assert_allclose(aux, jaux, rtol=1e-3, atol=1e-6)
    for k, (g, w) in grads.items():
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert rel <= 3e-2, (k, rel)


# ---------------------------------------------------------------------------
# The SSD scan's backward (a reference fault the port does not copy)
# ---------------------------------------------------------------------------

def _ssd_inputs(decay: float, L: int = 256):
    """B = 1, H = 4, P = N = 8, fp32, a constant decay ``da = -decay`` a
    token: one 256-token chunk (mamba2-370m's)."""
    r = np.random.RandomState(0)
    xdt = r.randn(1, L, 4, 8).astype(np.float32) * 0.1
    b = r.randn(1, L, 4, 8).astype(np.float32)
    c = r.randn(1, L, 4, 8).astype(np.float32)
    da = np.full((1, L, 4), -decay, np.float32)
    return xdt, da, b, c


def _port_ssd_grads(xdt, da, b, c, chunk=256):
    ts = [torch.tensor(a, requires_grad=True) for a in (xdt, da, b, c)]
    y, s = tssm._ssd_scan(*ts, chunk)
    (y.sum() + s.sum()).backward()
    return y.detach().numpy(), [t.grad.numpy() for t in ts]


def _reference_ssd_grads(xdt, da, b, c, chunk=256):
    def f(*args):
        y, s = jssm._ssd_scan(*args, chunk)
        return y.sum() + s.sum(), y

    (_, y), g = jax.value_and_grad(f, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(a) for a in (xdt, da, b, c)))
    return np.asarray(y), [np.asarray(t) for t in g]


def _close(got, want, name):
    """rtol 1e-5, and an atol of 1e-5 of the array's largest entry: the
    two scans sum in other orders."""
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max(), err_msg=name)


@pytest.mark.parametrize("decay", [0.5, 1.0])
def test_ssd_scan_backward_is_finite_where_the_reference_is_not(decay):
    """At 0.5 and 1.0 a token a 256-token chunk's decays pass fp32 exp's
    overflow (~88): the reference's ``where(mask, exp(ldec), 0)`` makes
    d(da) NaN (0 · inf), the port's masked ``exp`` keeps every gradient
    finite; the outputs and dx still agree."""
    inputs = _ssd_inputs(decay)
    y, g = _port_ssd_grads(*inputs)
    jy, jg = _reference_ssd_grads(*inputs)
    assert not np.isfinite(jg[1]).all()
    assert all(np.isfinite(t).all() for t in g)
    _close(y, jy, "y")
    _close(g[0], jg[0], "dxdt")


def test_ssd_scan_backward_matches_reference_below_the_overflow():
    """At 0.1 a token nothing overflows: output and every gradient agree
    with the reference's at rtol 1e-5."""
    inputs = _ssd_inputs(0.1)
    y, g = _port_ssd_grads(*inputs)
    jy, jg = _reference_ssd_grads(*inputs)
    _close(y, jy, "y")
    for name, a, w in zip(("dxdt", "dda", "db", "dc"), g, jg):
        _close(a, w, name)


@pytest.mark.parametrize("decay,L,chunk", [(0.1, 256, 256),
                                           (1.0, 256, 256), (0.5, 37, 16)])
def test_ssd_scan_forward_bit_equal_to_unmasked_form(decay, L, chunk):
    """Masking before the exp is the same forward, bit for bit: the
    port's scan against its own source with the reference's unmasked
    form (``where`` after the ``exp``) put back."""
    xdt, da, b, c = (torch.as_tensor(a) for a in _ssd_inputs(decay, L))
    masked = 'torch.exp(torch.where(mask, ldec, float("-inf")))'
    src = inspect.getsource(tssm._ssd_scan)
    assert masked in src
    scope = dict(vars(tssm))
    exec(src.replace(masked, "torch.where(mask, torch.exp(ldec), 0.0)"),
         scope)
    got = tssm._ssd_scan(xdt, da, b, c, chunk)
    want = scope["_ssd_scan"](xdt, da, b, c, chunk)
    for a, w in zip(got, want):
        assert torch.equal(a, w)


# ---------------------------------------------------------------------------
# MoE: the capacity scatter's gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["drops", "dropless"])
@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "mixtral-8x7b"])
def test_moe_gradients_reach_x_only_through_kept_pairs(arch, case):
    """One MoE layer's gradients (x, the router, the banks, the shared
    experts) under a random cotangent plus the aux loss, against
    ``jax.grad`` of the reference's layer: at capacity factor 0.5 pairs
    drop, and a dropped pair's spare-row write carries no gradient to
    x."""
    jcfg, cfg, jsub, tsub, x, res = _setup(arch, case)
    r = np.random.RandomState(12)
    cot = r.randn(*x.shape).astype(np.float32)

    def jloss(p, xx):
        y, aux = jmoe.moe_apply(p, xx, jcfg, residual=jnp.asarray(res))
        return jnp.sum(y * cot) + aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jsub, jnp.asarray(x))
    tp = {k: v.clone().requires_grad_(True) for k, v in tsub.items()}
    tx = torch.tensor(x, requires_grad=True)
    y, aux = tmoe.moe_apply(tp, tx, cfg, residual=torch.as_tensor(res))
    ((y * torch.as_tensor(cot)).sum() + aux).backward()
    top_i, _, _ = tmoe.route(tx.detach(), tsub["router"], cfg)
    _, _, keep = tmoe.dispatch(top_i, cfg.moe.n_experts,
                               tmoe.capacity(cfg, x.shape[1]))
    assert keep.all() == (case == "dropless")
    for name, g, w in [("x", tx.grad, jgx)] + [
            (k, tp[k].grad, jgp[k]) for k in sorted(tp)]:
        w = np.asarray(w)
        err = np.abs(g.numpy() - w).max()
        assert err <= 1e-4 * np.abs(w).max(), (name, err)


def test_dropped_pairs_carry_no_gradient():
    """A token whose every choice drops gets no gradient through the
    experts: with no shared experts and no residual its dx is the aux
    loss's alone (zero once the aux coefficient is 0)."""
    jcfg, cfg, _, tsub, x, _ = _setup("mixtral-8x7b", "drops")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, aux_loss_coef=0.0))
    tx = torch.tensor(x, requires_grad=True)
    y, _ = tmoe.moe_apply(tsub, tx, cfg)
    y.sum().backward()
    top_i, _, _ = tmoe.route(tx.detach(), tsub["router"], cfg)
    _, _, keep = tmoe.dispatch(top_i, cfg.moe.n_experts,
                               tmoe.capacity(cfg, x.shape[1]))
    k = cfg.moe.top_k
    dropped = ~keep.reshape(x.shape[0], x.shape[1], k).any(-1)
    kept = keep.reshape(x.shape[0], x.shape[1], k).all(-1)
    assert dropped.any() and kept.any()
    # The routing weights' gradient still reaches x through the router for
    # a kept choice; a token with every choice dropped has none at all.
    assert float(tx.grad[dropped].abs().max()) == 0.0
    assert float(tx.grad[kept].abs().max()) > 0.0


# ---------------------------------------------------------------------------
# Remat, microbatches
# ---------------------------------------------------------------------------

def _grads_of_step(cfg, batch, microbatches=1, seed=0):
    """The gradients one train step hands AdamW, and its metrics."""
    seen = []
    orig = adamw.update

    def spy(grads, *a, **kw):
        seen.append({k: v.detach().clone() for k, v in grads.items()})
        return orig(grads, *a, **kw)

    T.adamw.update = spy
    try:
        _, metrics = T.build_train_step(cfg, microbatches=microbatches)(
            T.init_state(cfg, seed, "cpu"), batch)
    finally:
        T.adamw.update = orig
    return seen[0], metrics


def _batch(cfg, seq_len=16, global_batch=4, step=0):
    return T.cast_batch(batch_for_model(cfg, DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq_len,
        global_batch=global_batch), step), cfg, "cpu")


@pytest.mark.parametrize("layers", [None, 7])
@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-7b"])
def test_remat_matches_no_remat(arch, layers):
    """Per-layer checkpoints (mamba2) and the hybrid's nested ones (a
    segment, its layers and the shared block; zamba2 also at 7 layers:
    three full groups of 2 and a partial one) recompute the same forward:
    the same loss and the same gradients."""
    cfg = dataclasses.replace(get_reduced(arch, "float32"), remat=False)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    batch = _batch(cfg)
    g0, m0 = _grads_of_step(cfg, batch)
    g1, m1 = _grads_of_step(dataclasses.replace(cfg, remat=True), batch)
    assert float(m0["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-6)
    for k in g0:
        np.testing.assert_allclose(g1[k].numpy(), g0[k].numpy(), rtol=1e-5,
                                   atol=1e-6 * float(g0[k].abs().max()),
                                   err_msg=k)


def test_microbatches_match_one_batch_without_aux():
    """deepseek, microbatches 2 against 1: with the aux coefficient at 0
    every gradient agrees to 1e-5 of its largest entry and the loss to
    1e-6 (capacity is per sequence, so routing does not change)."""
    cfg = get_reduced("deepseek-v2-lite-16b", "float32")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, aux_loss_coef=0.0))
    batch = _batch(cfg)
    g1, m1 = _grads_of_step(cfg, batch, 1)
    g2, m2 = _grads_of_step(cfg, batch, 2)
    assert float(m2["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-6)
    for k in g1:
        err = float((g1[k] - g2[k]).abs().max())
        assert err <= 1e-5 * float(g1[k].abs().max()), (k, err)


def test_microbatches_average_loss_aux_and_grads():
    """With the Switch aux loss (a product of two batch means, so not
    additive over microbatches) the step's loss, aux and gradients are
    the average of each microbatch's own, as the reference's scan
    averages them: deepseek, microbatches 2, each half through
    ``loss_fn`` on its own."""
    cfg = get_reduced("deepseek-v2-lite-16b", "float32")
    batch = _batch(cfg)
    g2, m2 = _grads_of_step(cfg, batch, 2)
    params = T.cast_params(T.init_state(cfg, 0, "cpu").params, cfg)
    keys = sorted(params)
    want = {k: torch.zeros_like(params[k]) for k in keys}
    loss = aux = 0.0
    for i in range(2):
        half = {k: T._split_mb(v, 2, i) for k, v in batch.items()}
        total, m = T.loss_fn(params, half, cfg)
        for k, g in zip(keys, torch.autograd.grad(
                total, [params[k] for k in keys])):
            want[k] += g / 2
        loss += m["loss"].item() / 2
        aux += m["aux"].item() / 2
    assert float(m2["loss"]) == pytest.approx(loss, rel=1e-6)
    assert float(m2["aux"]) == pytest.approx(aux, rel=1e-6)
    assert aux > 0.0
    for k in keys:
        err = float((g2[k] - want[k]).abs().max())
        assert err <= 1e-6 * float(want[k].abs().max()), (k, err)


# ---------------------------------------------------------------------------
# The launcher, checkpoints, launch counts, plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "zamba2-7b"])
def test_donated_step_is_bit_equal_to_the_functional_one(arch):
    """``build_train_step(..., donate=True)`` writes AdamW's results into
    the state's own tensors (one copy of masters and moments on the card
    instead of two) and gives the functional step's values bit for bit,
    over two steps with clipping."""
    cfg = get_reduced(arch)
    state = T.init_state(cfg, 0, "cpu")
    copy = T.TrainState(state.step.clone(),
                        {k: v.clone() for k, v in state.params.items()},
                        adamw.AdamWState(
                            state.opt.count.clone(),
                            {k: v.clone() for k, v in state.opt.m.items()},
                            {k: v.clone() for k, v in state.opt.v.items()}))
    ptrs = {k: v.data_ptr() for k, v in copy.params.items()}
    functional = T.build_train_step(cfg)
    donating = T.build_train_step(cfg, donate=True)
    for i in range(2):
        batch = _batch(cfg, step=i)
        state, m0 = functional(state, batch)
        copy, m1 = donating(copy, batch)
        assert float(m0["grad_norm"]) == float(m1["grad_norm"])
    assert {k: v.data_ptr() for k, v in copy.params.items()} == ptrs
    for k in state.params:
        assert torch.equal(copy.params[k], state.params[k]), k
        assert torch.equal(copy.opt.m[k], state.opt.m[k]), k
        assert torch.equal(copy.opt.v[k], state.opt.v[k]), k


@pytest.mark.parametrize("arch", list_archs())
def test_run_training_every_family(arch):
    """``run_training`` takes every arch (the embeds batches and the
    codebook labels of ``batch_for_model``): 2 steps, finite losses and
    state, no launch (the CPU runs the plain versions)."""
    K.reset_launch_counts()
    state, losses = run_training(arch, 2, seq_len=16, global_batch=4,
                                 device="cpu", log_every=100)
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert int(state.step) == 2
    assert all(bool(torch.isfinite(v).all()) for v in state.params.values())
    assert K.launch_counts == {}


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "zamba2-7b"])
def test_crash_and_resume_is_bit_equal(arch, tmp_path):
    """A MoE arch (an expert bank a leaf) and the hybrid (Mamba2 leaves
    and the shared block): a crash after step 2, a resume from step 1's
    checkpoint, and the resumed run's step-2 loss and every leaf of the
    state bit-equal to the uninterrupted run (one intra-op thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        kw = dict(seq_len=16, global_batch=4, device="cpu", log_every=100)
        want, want_losses = run_training(arch, 4, **kw)
        ckpt = str(tmp_path / "ckpt")
        with pytest.raises(RuntimeError, match="injected failure at step 2"):
            run_training(arch, 4, ckpt_dir=ckpt, ckpt_every=1, fail_at=2,
                         **kw)
        assert CheckpointManager(ckpt).latest_step() == 1
        got, losses = run_training(arch, 4, ckpt_dir=ckpt, ckpt_every=1,
                                   resume=True, **kw)
    finally:
        torch.set_num_threads(threads)
    assert losses == want_losses[2:]
    assert set(got.params) == set(M.model_defs(get_reduced(arch)))
    for k in want.params:
        assert torch.equal(got.params[k], want.params[k]), k
        assert torch.equal(got.opt.m[k], want.opt.m[k]), k
        assert torch.equal(got.opt.v[k], want.opt.v[k]), k


@pytest.fixture(scope="module")
def smoke():
    return _smoke()


def _count_programs(cfg, batch, monkeypatch):
    calls = {}
    orig = K.ca_gemm_program

    def counted(a, bs, **kw):
        key = K.launch_key(kw.get("spec", K.PLAIN).tag(),
                           K.layout_tag(kw.get("transpose_a", False),
                                        kw.get("transpose_b", False)),
                           kw.get("save_preact", False))
        calls[key] = calls.get(key, 0) + 1
        return orig(a, bs, **kw)

    monkeypatch.setattr(K, "ca_gemm_program", counted)
    T.build_train_step(cfg)(T.init_state(cfg, 0, "cpu"), batch)
    monkeypatch.undo()
    return calls


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("case", NEW_ARCHS + ["zamba2-7b@7", "zamba2-7b@5/3",
                                              "zamba2-7b@2/3"])
def test_k1_programs_per_step_match_the_smoke_formula(case, remat, smoke,
                                                      monkeypatch):
    """Every K1 program one train step calls, by launch key, equals
    ``chip_smoke.train_counts_per_step`` (the formula the card holds the
    full-width steps to): zamba2 also with partial groups (7 layers at
    every 2, 5 and 2 layers at every 3)."""
    arch, _, shape = case.partition("@")
    cfg = dataclasses.replace(get_reduced(arch), remat=remat)
    if shape:
        layers, _, every = shape.partition("/")
        cfg = dataclasses.replace(cfg, n_layers=int(layers))
        if every:
            cfg = dataclasses.replace(cfg, shared_attn_every=int(every))
    got = _count_programs(cfg, _batch(cfg, 8, 2), monkeypatch)
    assert got == smoke.train_counts_per_step(cfg)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_train_warmup_plans_match_reference(arch, tmp_path):
    """``warmup_model(cfg, rows, train=True)`` resolves the backward
    layouts of every new family (the expert programs at their capacity
    rows, MLA's projections, the Mamba2 in_proj and out_proj): on a
    target built from the reference's V5E fields its cache keys equal the
    reference's for the same arguments, and the train step built with
    ``warmup_gemm_rows`` resolves them."""
    from repro.core import V5E
    from repro.tuning import registry as jreg
    from repro.tuning import warmup_model as jwarmup
    from repro.tuning.cache import TuningCache as JCache
    from repro_torch.tuning import KernelRegistry, TuningCache, warmup_model
    from repro_torch.tuning import registry as treg
    from test_torch_io_model import TPU

    cfg, jcfg = get_reduced(arch), jax_reduced(arch)

    def ours(train):
        return warmup_model(cfg, [64], train=train, registry=KernelRegistry(
            cache=TuningCache(tmp_path / f"t{train}.json"),
            autotune_enabled=False, hw=TPU))

    ref = jwarmup(jcfg, [64], registry=jreg.KernelRegistry(
        cache=JCache(tmp_path / "j.json"), autotune_enabled=False, hw=V5E),
        train=True)
    assert ours(True).keys() == ref.keys()
    assert set(ours(False)) < set(ours(True))
    treg.reset_registry()
    T.build_train_step(cfg, warmup_gemm_rows=64)
    assert treg.get_registry().stats["analytic"] >= len(ref)
