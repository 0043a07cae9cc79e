"""Data substrate: deterministic synthetic LM pipeline + prefetch."""
from repro_torch.data.pipeline import Prefetcher, SyntheticLM  # noqa: F401
