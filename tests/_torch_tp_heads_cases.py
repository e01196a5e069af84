"""The cases of ``test_torch_tp_heads.py``, one call per gloo rank
(:func:`port_ranks`), each beside the one-rank module on the same inputs,
in fp32, on a ``model`` axis of 2 and of 4 ranks:

* GQA attention whose KV heads ``model`` splits, the KV projections read
  whole (``models.attention.kv_whole``): reduced granite-20b (4 query
  heads, one KV head) and reduced mixtral-8x7b (4 query heads, 2 KV
  heads, on 4 ranks: each rank's query head reads one of them; on 2
  ranks they divide, and the leaves stay column-parallel), each rank
  holding its ``wq`` columns and ``wo`` rows;
* musicgen-large's codebook heads (``(4, d, V)``, each rank its ``vocab``
  columns) and the vocab-parallel loss over codebook labels."""

import numpy as np

WORLD = 4
B, L = 2, 12
MESHES = {2: (2, 2), 4: (1, 4)}     # model size -> (data, model)
ATTN_ARCHS = ("granite-20b", "mixtral-8x7b")
# the attention cases: (arch, model size) where the KV heads are split
ATTN_CASES = (("granite-20b", 2), ("granite-20b", 4), ("mixtral-8x7b", 4))
HEAD_ARCH = "musicgen-large"


def cfg(arch):
    from repro_torch.configs import get_reduced

    return get_reduced(arch)


def attn_inputs(arch):
    """One layer's attention leaves (the port's seed-0 init), the input
    and the output's cotangent, from a seed."""
    import torch

    from repro_torch.models import attention as A
    from repro_torch.models import common as cm

    c = cfg(arch)
    torch.manual_seed(0)
    params = {k: v.numpy() for k, v in cm.init_params(
        A.gqa_defs(c), 0).items()}
    rng = np.random.RandomState(13)
    x = rng.randn(B, L, c.d_model).astype(np.float32)
    dy = rng.randn(B, L, c.d_model).astype(np.float32)
    return params, x, dy


def _attention(arch, params, x, dy, local=None):
    """Output and every gradient of ``sum(gqa_apply(params, x) * dy)``;
    ``local`` maps a leaf to the slice of it this rank holds."""
    import torch

    from repro_torch.models import attention as A

    local = local or {}
    p = {k: torch.from_numpy(v[local.get(k, slice(None))].copy())
         .requires_grad_() for k, v in params.items()}
    xt = torch.from_numpy(x).requires_grad_()
    pos = torch.arange(L)[None].expand(B, L)
    out, _ = A.gqa_apply(p, xt, cfg(arch), positions=pos, mode="train")
    (out * torch.from_numpy(dy)).sum().backward()
    grads = {k: v.grad.numpy() for k, v in p.items()}
    grads["x"] = xt.grad.numpy()
    return out.detach().numpy(), grads


def head_inputs():
    """The codebook heads (seed-0 init), the final hidden state, the
    codebook labels and a mask, from a seed."""
    import torch

    from repro_torch.models import common as cm

    c = cfg(HEAD_ARCH)
    torch.manual_seed(0)
    w = cm.init_params(cm.unembed_defs(c.d_model, c.vocab_size,
                                       c.n_codebooks), 0)["w"].numpy()
    rng = np.random.RandomState(17)
    x = rng.randn(B, L, c.d_model).astype(np.float32)
    labels = rng.randint(0, c.vocab_size,
                         (B, L, c.n_codebooks)).astype(np.int32)
    mask = (rng.rand(B, L) > 0.25).astype(np.float32)
    return w, x, labels, mask


def _head_loss(w, x, labels, mask, cols=slice(None)):
    """The loss of the codebook heads over ``x`` and its gradients: the
    heads' (this rank's ``vocab`` columns ``cols``) and the input's."""
    import torch

    from repro_torch.models import common as cm
    from repro_torch.models import model as M

    c = cfg(HEAD_ARCH)
    wt = torch.from_numpy(w[..., cols].copy()).requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    logits = cm.unembed_apply({"w": wt}, xt, c.n_codebooks)
    loss = M.lm_loss(logits, torch.from_numpy(labels), c,
                     torch.from_numpy(mask))
    loss.backward()
    return float(loss), {"w": wt.grad.numpy(), "x": xt.grad.numpy()}


def port_ranks(rank, world):
    import torch

    from repro_torch.core import distributed as D
    from repro_torch.launch.mesh import make_mesh_compat

    out = {"rank": rank}
    attn = {a: attn_inputs(a) for a in ATTN_ARCHS}
    head = head_inputs()
    out["one"] = {a: _attention(a, *attn[a]) for a in ATTN_ARCHS}
    out["one"][HEAD_ARCH] = _head_loss(*head)
    for tp, shape in MESHES.items():
        mesh = make_mesh_compat(shape, ("data", "model"), device="cpu")
        index = mesh.get_local_rank("model")
        ax = D._Axis(mesh, "model", torch.device("cpu"))
        got = {"index": index}
        for a in (a for a, n in ATTN_CASES if n == tp):
            c = cfg(a)
            q = c.n_heads * c.resolved_head_dim // tp
            mine = slice(index * q, (index + 1) * q)
            local = {"wq": (slice(None), mine), "wo": mine}
            before = dict(D.tp_wire_bytes)
            with D.model_parallel(lambda dev, ax=ax: ax, tp, index):
                y, grads = _attention(a, *attn[a], local)
            # the whole KV leaves' partial gradients summed over the
            # ranks, as train.fsdp's reduce-scatter does
            summed = {k: ax.all_reduce(torch.from_numpy(grads[k])).numpy()
                      for k in ("wk", "wv")}
            got[a] = {"out": y, "grads": grads, "summed": summed,
                      "cols": (mine.start, mine.stop),
                      "wire": _delta(D.tp_wire_bytes, before)}
        v = cfg(HEAD_ARCH).vocab_size // tp
        cols = slice(index * v, (index + 1) * v)
        before = dict(D.tp_wire_bytes)
        with D.model_parallel(lambda dev, ax=ax: ax, tp, index):
            loss, grads = _head_loss(*head, cols)
        got[HEAD_ARCH] = {"loss": loss, "grads": grads,
                          "cols": (cols.start, cols.stop),
                          "wire": _delta(D.tp_wire_bytes, before)}
        out[tp] = got
    return out


def _delta(now, before):
    return {k: v - before.get(k, 0) for k, v in now.items()
            if v != before.get(k, 0)}
