"""The plain PyTorch reference of the benchmark's configurations: fp32,
TF32 off, no kernel, cache or batching of the program, which it does not
import."""
