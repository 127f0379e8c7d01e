"""NPE numerics in PyTorch: PWL tables, the MMU's quantization, the NVU."""
