"""A frozen copy of the port's plain Python engine, for the benchmark's
reference: the PAF parse (``paf``), the cs walk (``events``), the scalar
event analysis and report rows (``diff_report``), the progressive MSA
with its consensus vote and scalar clip refinement (``gapseq``,
``msa``), and DNA helpers (``dna``).  Device and native paths are cut:
everything here is plain Python and NumPy.  It imports nothing of the
program, so a later change to the program cannot move the yardstick.
"""
