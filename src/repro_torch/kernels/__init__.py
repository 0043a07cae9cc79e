"""The model substrate's kernels: hand-written CUDA kernels for the TPU
kernels on the serving path (K4 flash attention, K5 RMSNorm), their plain
PyTorch versions, and the dispatch between them (:mod:`.ops`)."""
