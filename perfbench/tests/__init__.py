"""CPU tests of the benchmark: its traffic, arithmetic, reference and
drivers at small sizes (the kernels' plain versions), and the faults and
control its comparisons must catch. Tests that need a card skip here."""
