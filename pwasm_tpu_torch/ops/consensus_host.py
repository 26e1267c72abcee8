"""Consensus constants shared by the pileup renderer and the kernels.

Base codes: A=0 C=1 G=2 T=3 N=4 gap=5; any code outside [0, 6)
contributes nothing to a column's counts.
"""

from __future__ import annotations

N_CLASSES = 6
CODE_ZERO_COV = -1
PAD_CODE = 6  # any code >= 6 contributes nothing to the pileup
