"""Report writers: the .dfa diff report and the summary counters."""
