"""Feature extractors of the port (wordrate, static embeddings) and FIR."""
