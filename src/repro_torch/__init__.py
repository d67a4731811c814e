"""PyTorch and CUDA port of the PASS reproduction (`repro`).

Laid out like `repro`: `core/` holds the problems, the Glauber primitives
and the `sampler_api.run()` driver; `kernels/` holds the hand-written
Hopper (sm_90a) kernels, their plain PyTorch versions and the `ops`
dispatch; `configs/`, `models/`, `serve/`, `train/`, `optim/`, `data/` and
`launch/` the LMs' serving and training stack on one device. The package
imports torch, numpy and the standard library only.

Entry points run on the CUDA device unless the caller passes
`device="cpu"`; on CPU tensors every kernel wrapper runs its plain version.
"""
