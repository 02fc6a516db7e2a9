"""Device compute: seed lookup, voting, banded Smith-Waterman, ranking — each kernel beside its plain PyTorch version."""
