"""Gapped-sequence / MSA engine.

Equivalent capability set to the reference's GapAssem library (GapAssem.h,
GapAssem.cpp): gapped-coordinate bookkeeping, gap propagation across an MSA,
progressive pairwise->MSA merging, column voting/consensus, X-drop clip
refinement, and the MFA/ACE/contig-info writers.  The device programs
(`pwasm_tpu_torch.ops`) consume the pileup tensors this layer produces.
"""
