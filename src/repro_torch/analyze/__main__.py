"""CLI entry (port of ``repro/analyze/__main__.py``): ``python -m
repro_torch.analyze {lint,cache,report} ...``; it needs torch, never JAX.

``lint`` runs the AST pass (:mod:`repro_torch.analyze.lint`); ``cache``
lints a persisted tuning cache (``python -m repro_torch.tuning.cache
lint``); ``report`` is the static pre-deploy sweep: it resolves the
config zoo's representative serve GEMMs through the registry for the
card and verifies every plan, shared memory included, without touching
the card.
"""

from __future__ import annotations

import sys
from typing import List, Optional, Sequence, Tuple


def _arch_gemms(cfg) -> List[Tuple[str, int, int, str]]:
    """(name, n, k, tag) for one arch's representative serve GEMMs."""
    d = cfg.d_model
    gemms: List[Tuple[str, int, int, str]] = []
    if cfg.attn_kind == "gqa":
        Dh = cfg.resolved_head_dim
        gemms.append(("qkv", (cfg.n_heads + 2 * cfg.n_kv_heads) * Dh, d,
                      "none"))
        gemms.append(("attn_out", d, cfg.n_heads * Dh, "none"))
    if cfg.ssm is not None:
        di = cfg.ssm.d_inner(d)
        n_in = (2 * di + 2 * cfg.ssm.n_groups * cfg.ssm.d_state
                + cfg.ssm.n_heads(d))
        gemms.append(("ssm_in", n_in, d, "none"))
        gemms.append(("ssm_out", d, di, "none"))
    if cfg.d_ff > 0:
        if cfg.act == "silu":
            gemms.append(("ffn_glu", cfg.d_ff, d,
                          "rms>glu.silu(none|none)"))
        else:
            gemms.append(("ffn_up", cfg.d_ff, d, f"rms>bias+{cfg.act}"))
        gemms.append(("ffn_down", d, cfg.d_ff, "none"))
    gemms.append(("lm_head", cfg.padded_vocab, d, "none"))
    return [(name, n, k, tag) for name, n, k, tag in gemms
            if n > 0 and k > 0]


def report(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analyze report",
        description="Static dry-run over the config zoo: resolve each "
                    "arch's representative GEMMs and verify the plans.")
    ap.add_argument("--arch", action="append", default=None,
                    help="architecture name (repeatable; default: all)")
    ap.add_argument("--prefill-m", type=int, default=4096)
    ap.add_argument("--decode-m", type=int, default=1,
                    help="decode rows (the engine serves one request at a "
                         "time: 1)")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.analyze.validate import (planned_smem_bytes,
                                              validate_program)
    from repro_torch.configs import get_config, list_archs
    from repro_torch.kernels.program import program_from_tag
    from repro_torch.tuning import get_registry

    registry = get_registry()
    hw = registry.hw
    archs = args.arch or list_archs()
    n_diags = 0
    print(f"# static plan report: hw={hw.name} (shared memory "
          f"{hw.smem_per_block} B a block)")
    for arch in archs:
        cfg = get_config(arch)
        print(f"\n{arch} (d_model={cfg.d_model}, d_ff={cfg.d_ff})")
        for phase, m in (("decode", args.decode_m),
                         ("prefill", args.prefill_m)):
            for name, n, k, tag in _arch_gemms(cfg):
                res = registry.resolve_full(m, n, k, dtype=torch.bfloat16,
                                            hw=hw, epilogue=tag)
                t = res.config
                need, route = planned_smem_bytes(
                    program_from_tag(tag), t, dtype=torch.bfloat16, m=m,
                    n=n, k=k, hw=hw)
                diags = validate_program(tag, t, hw, dtype=torch.bfloat16,
                                         m=m, n=n, k=k)
                status = "OK" if not diags else \
                    ",".join(sorted({d.code for d in diags}))
                print(f"  {phase:7s} {name:9s} m={m:<5d} n={n:<6d} "
                      f"k={k:<6d} tile=({t.bm},{t.bn},{t.bk}) "
                      f"route={route:6s} src={res.source:8s} "
                      f"smem={need:>7d}B {status}")
                for diag in diags:
                    n_diags += 1
                    print(f"           !! {diag}")
    print(f"\n{n_diags} diagnostic(s)")
    return 1 if n_diags else 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        print("subcommands: lint <paths> [--format json] | cache [PATH] "
              "[--strip] | report [--arch NAME]")
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "lint":
        from repro_torch.analyze.lint import main as lint_main

        return lint_main(rest)
    if cmd == "cache":
        from repro_torch.tuning.cache import main as cache_main

        return cache_main(["lint", *rest])
    if cmd == "report":
        return report(rest)
    print(f"unknown subcommand {cmd!r} (want: lint | cache | report)",
          file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
