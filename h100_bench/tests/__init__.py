"""CPU tests of the benchmark; the card-only ones are marked ``cuda``."""
