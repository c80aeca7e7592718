from sahara_jax.io.fasta import FastaRecord, read_fasta, write_fasta  # noqa: F401
