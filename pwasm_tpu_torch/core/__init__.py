"""Host-side data model: DNA tables, FASTA access, PAF/cs/CIGAR parsing,
diff-event extraction."""
