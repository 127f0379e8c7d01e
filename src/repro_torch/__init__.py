"""PyTorch/CUDA port of the NPE reproduction (counterpart of `repro`).

The port runs the BERT-base encoder in float and NPE modes on an NVIDIA
Hopper card, with every kernel of that path written by hand in CUDA C++
(`repro_torch/csrc/`).  It imports torch and numpy only.
"""
