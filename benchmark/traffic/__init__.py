"""Traffic of the benchmark: one JSON file of parameters per mix
(``<traffic>.json``) and the general generators that read them."""
