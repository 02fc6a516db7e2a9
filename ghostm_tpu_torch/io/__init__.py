"""FASTA/FASTQ readers."""
