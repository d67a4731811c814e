"""The JAX package's examples on the port (`examples/*.py` there), each a
module with a `main(argv=None)` that keeps its script's flags, defaults and
printed lines, adds `--device` (default cuda; cpu runs the plain versions),
and returns the printed headline quantities as a dict:

    python -m repro_torch.examples.quickstart [--device cpu]
    python -m repro_torch.examples.optimization_cal [--device cpu]
    python -m repro_torch.examples.boltzmann_mnist [--steps 300] [--digit 3] [--device cpu]
    python -m repro_torch.examples.neural_decision [--device cpu]
    python -m repro_torch.examples.serve_lm [--arch xlstm-125m] [--requests 6] [--device cpu]
    python -m repro_torch.examples.train_lm [--arch gemma-2b] [--steps 60] [--device cpu]

Seeds are ints or `torch.Generator`s, as everywhere in the port, so the
sampled numbers are not the JAX scripts' (torch cannot replay threefry).
"""
