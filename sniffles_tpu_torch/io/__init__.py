"""I/O and file-format layer of the port: FASTA, VCF, SNF."""
