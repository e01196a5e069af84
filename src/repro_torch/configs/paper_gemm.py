"""The paper's own benchmark scenario: standalone CA-MMM kernels.

Table 2 evaluates square matrices (16384^3 for Fig. 7) over fp16/32/64
and uint8/16/32.  The port's dtype set is the reference's: bf16, fp32 and
int8 (the dtypes K1 takes on the card).
"""
from typing import Tuple

import torch

MATRIX_SIZES: Tuple[int, ...] = (1024, 2048, 4096, 8192, 16384)
DTYPES = (torch.bfloat16, torch.float32, torch.int8)
PAPER_N = 16384  # n = m = k used in the paper's Fig. 7 strong scaling
