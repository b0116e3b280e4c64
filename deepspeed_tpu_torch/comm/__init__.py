"""Communication: only the sign compression of the 1-bit optimizers is ported;
the collectives wait for data parallelism (ROADMAP.md queue 1 item 11)."""
