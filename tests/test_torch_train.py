"""The port's training path on the CPU (plain versions) against the
reference's: data batches, the AdamW update, and the loss and gradients
of ``train.step.loss_fn`` on the reference's reduced config; then the
port's own counterparts of the reference's training checks (loss
decreases, microbatch equivalence, remat)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.data import pipeline as jdata
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro.train import step as JT
from repro_torch.configs import get_reduced
from repro_torch.data import pipeline as tdata
from repro_torch.kernels import ca_mmm as K
from repro_torch.launch.train import run_training
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.train import step as T


def _small(cfg):
    """The reference's ``tests/test_train.py:_small_cfg``."""
    return dataclasses.replace(cfg, n_layers=2, d_model=64, n_heads=4,
                               n_kv_heads=4, d_ff=128, vocab_size=256,
                               remat=False)


@pytest.mark.parametrize("dc", [
    {"vocab_size": 256, "seq_len": 16, "global_batch": 8},
    {"vocab_size": 1000, "seq_len": 33, "global_batch": 6, "seed": 7,
     "noise": 0.0},
    {"vocab_size": 512, "seq_len": 8, "global_batch": 8, "n_hosts": 2,
     "host_id": 1},
])
def test_synthetic_batches_are_bit_equal(dc):
    ours = tdata.SyntheticLM(tdata.DataConfig(**dc))
    ref = jdata.SyntheticLM(jdata.DataConfig(**dc))
    cfg = get_reduced("stablelm-1.6b")
    for step in (0, 1, 17):
        a, b = ours.batch_at(step), ref.batch_at(step)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    got = tdata.batch_for_model(cfg, tdata.DataConfig(**dc), 3)
    assert all(np.array_equal(got[k], ref.batch_at(3)[k]) for k in got)


def test_adamw_update_matches_reference():
    """Three updates through warmup into the cosine decay, with clipping
    (the global norm is above clip_norm) and the ndim ≥ 2 decay mask, on
    fp32 masters with bf16 matrix gradients: rtol 1e-6."""
    r = np.random.RandomState(0)
    params = {"w": r.randn(6, 5).astype(np.float32),
              "b": r.randn(5).astype(np.float32),
              "e": r.randn(3, 4).astype(np.float32)}
    cfg_kw = dict(lr=1e-2, weight_decay=0.1, clip_norm=0.5, warmup_steps=2,
                  total_steps=5)
    jcfg, tcfg = jadamw.AdamWConfig(**cfg_kw), adamw.AdamWConfig(**cfg_kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.as_tensor(v) for k, v in params.items()}
    js, ts = jadamw.init(jp), adamw.init(tp)
    for step in range(3):
        grads = {k: r.randn(*v.shape).astype(np.float32) * 3
                 for k, v in params.items()}
        jg = {k: jnp.asarray(v, jnp.bfloat16 if v.ndim >= 2 else None)
              for k, v in grads.items()}
        tg = {k: torch.as_tensor(v).to(torch.bfloat16 if v.ndim >= 2
                                       else torch.float32)
              for k, v in grads.items()}
        jp, js, jm = jadamw.update(jg, js, jp, jcfg)
        tp, ts, tm = adamw.update(tg, ts, tp, tcfg)
        assert int(ts.count) == int(js.count) == step + 1
        for name in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                       rtol=1e-6)
        for ours, ref in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
            for k in params:
                assert ours[k].dtype == torch.float32
                np.testing.assert_allclose(ours[k].numpy(),
                                           np.asarray(ref[k]), rtol=1e-6,
                                           atol=1e-9)


def _loss_and_grads(dtype: str):
    """loss_fn's loss and per-leaf gradients, port and reference, on the
    same params (the reference's init, carried across as fp32 masters) cast
    to ``dtype`` as ``build_train_step`` casts them, and the same batch."""
    jcfg = _small(jax_reduced("stablelm-1.6b", dtype))
    tcfg = _small(get_reduced("stablelm-1.6b", dtype))
    masters = {k: np.asarray(v) for k, v in
               JM.init_params(jcfg, jax.random.PRNGKey(0)).items()}
    batch = jdata.SyntheticLM(jdata.DataConfig(
        vocab_size=jcfg.vocab_size, seq_len=16, global_batch=4)).batch_at(0)
    jp = {k: jnp.asarray(v, jcfg.dtype() if v.ndim >= 2 else jnp.float32)
          for k, v in masters.items()}
    (_, jm), jgr = jax.value_and_grad(JT.loss_fn, has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    tp = T.cast_params(M.params_from_jax(masters, tcfg, device="cpu",
                                         masters=True), tcfg)
    loss, tm = T.loss_fn(tp, T.cast_batch(batch, tcfg, "cpu"), tcfg)
    keys = sorted(tp)
    grads = torch.autograd.grad(loss, [tp[k] for k in keys])
    return (loss.item(), float(jm["loss"]),
            {k: (g.float().numpy(), np.asarray(jgr[k], np.float32))
             for k, g in zip(keys, grads)})


def test_loss_and_grads_match_reference_fp32():
    # fp32 compute: the same arithmetic up to summation order.
    ours, ref, grads = _loss_and_grads("float32")
    np.testing.assert_allclose(ours, ref, rtol=1e-5)
    assert len(grads) == 12
    for k, (g, w) in grads.items():
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), k


def test_loss_and_grads_match_reference_bf16():
    """bf16 compute: both round every GEMM output and weight to bf16, but
    at other places in the backward (the port rounds each cotangent to
    bf16 before its K1f GEMM, as the reference's kernel VJP does, where
    the reference's XLA-mode autodiff keeps it in fp32), so the loss is
    held at rtol 1e-3 and each gradient leaf at a relative L2 error of
    3e-2: about four bf16 ulps (2^-8 each), three times the worst leaf
    seen (1.05e-2, ``blocks/norm_attn/scale``)."""
    ours, ref, grads = _loss_and_grads("bfloat16")
    np.testing.assert_allclose(ours, ref, rtol=1e-3)
    for k, (g, w) in grads.items():
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert rel <= 3e-2, (k, rel)


def _small_port(**kw):
    return dataclasses.replace(_small(get_reduced("stablelm-1.6b")), **kw)


def _batch(cfg, seq_len, global_batch, step=0, **kw):
    data = tdata.SyntheticLM(tdata.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq_len,
        global_batch=global_batch, **kw))
    return T.cast_batch(data.batch_at(step), cfg, "cpu")


def test_loss_decreases():
    cfg = _small_port()
    state = T.init_state(cfg, 0, "cpu")
    opt = adamw.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=60,
                            weight_decay=0.0)
    step_fn = T.build_train_step(cfg, opt)
    losses = []
    for i in range(40):
        state, m = step_fn(state, _batch(cfg, 32, 8, i, noise=0.0))
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.8, losses[::8]


def test_microbatch_equivalence():
    """mb = 1 vs mb = 4 (strided split, fp32 accumulation): the same
    update."""
    cfg = _small_port()
    opt = adamw.AdamWConfig(lr=1e-3, clip_norm=None, weight_decay=0.0)
    b = _batch(cfg, 16, 8)
    s0 = T.init_state(cfg, 1, "cpu")
    s1, m1 = T.build_train_step(cfg, opt, microbatches=1)(s0, b)
    s4, m4 = T.build_train_step(cfg, opt, microbatches=4)(s0, b)
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]),
                               rtol=1e-5)
    for k in s1.params:
        np.testing.assert_allclose(s1.params[k].numpy(),
                                   s4.params[k].numpy(), rtol=2e-4,
                                   atol=2e-5)


def test_remat_matches_no_remat():
    """The checkpointed layers recompute the same forward: same loss, same
    update."""
    cfg = _small_port()
    b = _batch(cfg, 16, 4)
    s0 = T.init_state(cfg, 2, "cpu")
    opt = adamw.AdamWConfig(lr=1e-3, clip_norm=None)
    s_a, m_a = T.build_train_step(cfg, opt)(s0, b)
    s_b, m_b = T.build_train_step(dataclasses.replace(cfg, remat=True),
                                  opt)(s0, b)
    np.testing.assert_allclose(float(m_a["loss"]), float(m_b["loss"]),
                               rtol=1e-5)
    for k in s_a.params:
        np.testing.assert_allclose(s_a.params[k].numpy(),
                                   s_b.params[k].numpy(), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("remat", [False, True])
def test_gemm_programs_per_step(remat, monkeypatch):
    """Every GEMM of a step is a CA-GEMM program: per layer 6 forward
    programs (3 ``none``, 2 ``res``, the GLU with save_preact) and 14
    backward (nt + tn per one-branch program, 4 for the GLU), plus the
    head's 1 + 2; remat recomputes each layer's 6.  (On the card these are
    the kernel's launch counts; ``chip_smoke.py`` asserts them.)"""
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
    cfg = _small_port(remat=remat)
    L = cfg.n_layers
    T.build_train_step(cfg)(T.init_state(cfg, 0, "cpu"), _batch(cfg, 8, 2))
    glu = "rms>glu.silu(none|none) save_preact"
    fwd = 2 if remat else 1
    assert calls == {"none": (3 * L) * fwd + 1, "res": 2 * L * fwd,
                     glu: L * fwd, "none nt": 6 * L + 1,
                     "none tn": 6 * L + 1, "dact.silu>none nt": L,
                     "dact.silu@b>none tn": L}
    assert sum(calls.values()) == 6 * L * fwd + 1 + 14 * L + 2


def test_run_training_on_the_cpu(tmp_path):
    K.reset_launch_counts()
    _, losses = run_training("stablelm-1.6b", 2, seq_len=16,
                             global_batch=4, device="cpu")
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert K.launch_counts == {}        # the CPU runs the plain versions
    # checkpoints are ported: the last step is saved and verifies
    from repro_torch.checkpoint import CheckpointManager

    run_training("stablelm-1.6b", 1, seq_len=8, global_batch=2,
                 device="cpu", ckpt_dir=str(tmp_path))
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 0 and mgr.verify_step(0)
    with pytest.raises(RuntimeError, match="injected failure at step 0"):
        run_training("stablelm-1.6b", 2, seq_len=8, global_batch=2,
                     device="cpu", fail_at=0)


def test_every_training_launch_takes_the_wgmma_route(monkeypatch):
    """A bf16 train step of the reduced stablelm-1.6b with remat (widths
    multiples of 8, 2 x 16 tokens): every K1 call of every launch key the
    full-width step has (627 launches there) routes to the wgmma main loop
    on the card, by the operands it is actually given."""
    routes = {}
    orig = K.ca_gemm_program

    def spy(a, bs, **kw):
        spec = kw.get("spec", K.PLAIN)
        ta, tb = kw.get("transpose_a", False), kw.get("transpose_b", False)
        layout = K.layout_tag(ta, tb)
        k, m = a.shape if ta else a.shape[::-1]
        n = bs[0].shape[0 if tb else 1]
        route = K.k1_route(spec, layout, a.dtype, bs[0].dtype, m, n, k,
                           K.tma_aligned(a, *bs, kw.get("preact")))
        key = K.launch_key(spec.tag(), layout, kw.get("save_preact", False))
        routes.setdefault(key, set()).add(route)
        return orig(a, bs, **kw)

    monkeypatch.setattr(K, "ca_gemm_program", spy)
    cfg = _small_port(remat=True, compute_dtype="bfloat16")
    T.build_train_step(cfg)(T.init_state(cfg, 0, "cpu"),
                            _batch(cfg, 16, 2))
    glu = "rms>glu.silu(none|none) save_preact"
    assert set(routes) == {"none", "res", glu, "none nt", "none tn",
                           "dact.silu>none nt", "dact.silu@b>none tn"}
    assert all(r == {"wgmma"} for r in routes.values()), routes
