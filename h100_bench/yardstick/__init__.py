"""Frozen arithmetic of the benchmark: FLOP and byte counts, the card's
peaks, the table of kernel kinds and the reduction of a profiler trace."""
