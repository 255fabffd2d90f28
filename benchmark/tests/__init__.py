"""CPU tests of the benchmark's yardstick, and its card-only checks."""
