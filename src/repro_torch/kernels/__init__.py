"""The model substrate's kernels: hand-written CUDA kernels for the TPU
kernels on the serving paths (K4 flash attention, K5 RMSNorm, K6 the RWKV-6
recurrence), their plain PyTorch versions, and the dispatch between them
(:mod:`.ops`)."""
