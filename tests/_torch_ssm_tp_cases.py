"""The tensor-parallel Mamba2 mixer's cases, one call per gloo rank
(:func:`port_ranks`): reduced mamba2-370m in fp32, the mixer's forward
and backward on each rank's heads inside ``core.distributed.model_parallel``
on a ``model`` axis of 2 and of 4 ranks, beside the one-rank mixer on the
same inputs; and the gated norm's statistic alone, with the loss reading
none of one rank's channels."""

import numpy as np

ARCH = "mamba2-370m"
WORLD = 4
B, L = 2, 20        # L not a multiple of the chunk: the scan pads
MESHES = {2: (2, 2), 4: (1, 4)}     # model size -> (data, model)


def cfg():
    from repro_torch.configs import get_reduced

    return get_reduced(ARCH)


def inputs():
    """The mixer's whole leaves (the port's seed-0 init of one layer),
    its input and its output's cotangent, from a seed."""
    import torch

    from repro_torch.models import common as cm
    from repro_torch.models import ssm

    c = cfg()
    torch.manual_seed(0)
    params = {k: v.numpy() for k, v in cm.init_params(
        ssm.mamba2_defs(c), 0).items()}
    rng = np.random.RandomState(11)
    # a_log and dt_bias as the init draws them; the rest moved off their
    # constant init so every gradient has a value to be held to
    params["d_skip"] = (1 + 0.1 * rng.randn(*params["d_skip"].shape)
                        ).astype(np.float32)
    params["norm"] = (1 + 0.1 * rng.randn(*params["norm"].shape)
                      ).astype(np.float32)
    params["conv_b"] = (0.1 * rng.randn(*params["conv_b"].shape)
                        ).astype(np.float32)
    x = rng.randn(B, L, c.d_model).astype(np.float32)
    dy = rng.randn(B, L, c.d_model).astype(np.float32)
    return params, x, dy


def _mixer(params, x, dy, local=None):
    """Output and every gradient of ``sum(mamba2_apply(params, x) * dy)``;
    ``local`` maps a leaf to the slice of it this rank holds."""
    import torch

    from repro_torch.models import ssm

    local = local or {}
    p = {k: torch.from_numpy(v[local.get(k, slice(None))].copy())
         .requires_grad_() for k, v in params.items()}
    xt = torch.from_numpy(x).requires_grad_()
    out, _ = ssm.mamba2_apply(p, xt, cfg(), mode="train")
    (out * torch.from_numpy(dy)).sum().backward()
    grads = {k: v.grad.numpy() for k, v in p.items()}
    grads["x"] = xt.grad.numpy()
    return out.detach().numpy(), grads


def _norm_case(tp, index):
    """The gated norm's statistic (``models.ssm._tp_rms_norm``) on this
    rank's channels of one row set, the cotangent zero on the last rank's
    channels; and the one-rank ``rms_norm`` of the whole rows."""
    import torch

    from repro_torch.models import common as cm
    from repro_torch.models import ssm

    c = cfg()
    di = c.ssm.d_inner(c.d_model)
    rng = np.random.RandomState(5)
    y = rng.randn(B, L, di).astype(np.float32)
    gain = (1 + 0.1 * rng.randn(di)).astype(np.float32)
    dy = rng.randn(B, L, di).astype(np.float32)
    dy[..., di - di // tp:] = 0.0
    w = di // tp
    cols = slice(index * w, (index + 1) * w)
    yt = torch.from_numpy(y).requires_grad_()
    cm.rms_norm(yt, torch.from_numpy(gain), c.norm_eps).mul(
        torch.from_numpy(dy)).sum().backward()
    yl = torch.from_numpy(y[..., cols].copy()).requires_grad_()
    out = ssm._tp_rms_norm(yl, torch.from_numpy(gain[cols].copy()),
                           c.norm_eps, di)
    out.mul(torch.from_numpy(dy[..., cols].copy())).sum().backward()
    want = cm.rms_norm(torch.from_numpy(y), torch.from_numpy(gain),
                       c.norm_eps)[..., cols]
    return {"out": out.detach().numpy(), "want out": want.numpy(),
            "dy": yl.grad.numpy(), "want dy": yt.grad[..., cols].numpy()}


def port_ranks(rank, world):
    import torch

    from repro_torch.core import distributed as D
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.models import ssm

    c = cfg()
    params, x, dy = inputs()
    out = {"rank": rank, "one": _mixer(params, x, dy)}
    s = c.ssm
    di, h = s.d_inner(c.d_model), s.n_heads(c.d_model)
    for tp, shape in MESHES.items():
        mesh = make_mesh_compat(shape, ("data", "model"), device="cpu")
        index = mesh.get_local_rank("model")
        rows = slice(index * di // tp, (index + 1) * di // tp)
        ax = D._Axis(mesh, "model", torch.device("cpu"))
        before = dict(D.tp_wire_bytes)
        with D.model_parallel(lambda dev, ax=ax: ax, tp, index):
            y, grads = _mixer(params, x, dy, {"norm": rows,
                                              "out_proj": rows})
            norm = _norm_case(tp, index)
        # the partial gradients summed over the ranks, as train.fsdp does
        summed = {k: ax.all_reduce(torch.from_numpy(grads[k])).numpy()
                  for k in ("in_proj", "conv_w", "conv_b", "a_log",
                            "d_skip", "dt_bias")}
        out[tp] = {"index": index, "out": y, "grads": grads,
                   "summed": summed, "norm": norm,
                   "wire": {k: v - before.get(k, 0)
                            for k, v in D.tp_wire_bytes.items()
                            if v != before.get(k, 0)},
                   "columns": ssm.tp_columns(c, tp, index),
                   "heads": h // tp}
    return out
