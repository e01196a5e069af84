"""Hardware constants (port of ``repro/core/hardware.py``): the paper's
resource vector, re-derived for one NVIDIA H100.

The paper (Sec. 2, Eq. 1) models an FPGA as a resource vector plus the
fast memory ``S`` its compute tile and feeds live in.  On Hopper a CTA's
fast memory is its register accumulator plus its ring of shared-memory
stages, the compute quantum is one WGMMA (m in steps of 64 rows, n in
steps of 8 up to 256, k in steps of 32 bytes: 16 bf16 or 32 int8), and
the slow memory is HBM.  Everything downstream (the tile solver, the
roofline, the ledger's planned seconds, ``chip_smoke.py``'s bounds) reads
these constants from one :class:`HopperTarget`.

The constants are NVIDIA's data sheet for the H100 SXM part, dense rates
without sparsity, at the full 700 W power limit (the card measured in
``PERF.md``: NVIDIA H100 80GB HBM3, 700 W).

The solver reads the rates, ``fast_bytes`` and the quanta, so a target of
another machine is built from its own numbers; the CPU parity tests
build one from the reference's ``V5E`` fields and hold the solver
against the reference's choices.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

KIB = 1024


def as_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or a name
    (``"bfloat16"``, ``"int8"``)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = str(getattr(dtype, "name", dtype))
    out = getattr(torch, name, None)
    if not isinstance(out, torch.dtype):
        raise ValueError(f"not a dtype: {dtype!r}")
    return out


def dtype_name(dtype) -> str:
    """The dtype's name as the reference's keys spell it
    (``jnp.dtype(...).name``): ``"bfloat16"``, ``"float32"``, ``"int8"``."""
    return str(as_dtype(dtype)).removeprefix("torch.")


def itemsize(dtype) -> int:
    return as_dtype(dtype).itemsize


@dataclasses.dataclass(frozen=True)
class HopperTarget:
    """Hardware constants of one card, as the I/O model reads them."""

    name: str = "h100"
    card: str = "NVIDIA H100 80GB HBM3, 700 W"

    # Compute: dense tensor-core bf16 and int8; fp32 outside the tensor
    # cores (the SIMT route's rate).
    peak_flops_bf16: float = 989e12
    peak_flops_fp32: float = 67e12
    peak_flops_int8: float = 1979e12

    # Fast memory "S" of one CTA: the accumulator's share of the 256 KiB
    # register file (half of it: the rest holds fragments, addresses and
    # the producer) plus at most 227 KiB of shared memory a block.
    acc_register_bytes: int = 128 * KIB
    smem_per_block: int = 227 * KIB
    fast_bytes: int = 128 * KIB + 227 * KIB

    # Slow memory.
    hbm_bytes: int = 80 * 10 ** 9
    hbm_bandwidth: float = 3.35e12          # B/s
    sms: int = 132

    # Links of the distributed cost model (``core/distributed.py``), the
    # reference's ICI and DCN terms: NVLink to the other cards of the
    # host, 450 GB/s each way (900 GB/s all to all), and between hosts
    # one 400 Gb/s network adapter per card.
    ici_bandwidth: float = 450e9            # B/s, one way, one card
    dcn_bandwidth: float = 50e9             # B/s per card, pod axis

    # The compute quantum (the Eq. 8 analog): WGMMA's m step is one
    # warpgroup's 64 rows, n runs in steps of 8 up to 256, k in steps of
    # 32 bytes (8 fp32, 16 bf16, 32 int8), i.e. ``quantum_k`` elements of
    # a 4-byte type, packed along ``packed_axis`` for narrower ones.
    quantum_m: int = 64
    quantum_n: int = 8
    quantum_k: int = 8
    packed_axis: str = "k"
    max_n: int = 256                         # 0: no cap but the solver's

    # The kernels run only the tiles their routes instantiate
    # (``kernels/ca_mmm.py:route_tile``), so a tile is chosen among those.
    route_tiles: bool = True

    def peak_flops(self, dtype) -> float:
        dtype = as_dtype(dtype)
        if dtype in (torch.bfloat16, torch.float16):
            return self.peak_flops_bf16
        if dtype in (torch.int8, torch.uint8):
            return self.peak_flops_int8
        return self.peak_flops_fp32

    def tile_quantum(self, dtype) -> Tuple[int, int, int]:
        """The (m, n, k) step a tile grows by for ``dtype``: a 4-byte type
        takes the base quanta, narrower types pack 2x / 4x along
        ``packed_axis``."""
        packing = max(1, 4 // itemsize(dtype))
        qm, qn, qk = self.quantum_m, self.quantum_n, self.quantum_k
        if self.packed_axis == "m":
            return qm * packing, qn, qk
        return qm, qn, qk * packing


# The card of this port.
H100 = HopperTarget()

TARGETS: Dict[str, HopperTarget] = {"h100": H100}


def get_target(name: str = "h100") -> HopperTarget:
    return TARGETS[name]
