"""CPU tests of the benchmark harness; the card runs perfbench.run."""
