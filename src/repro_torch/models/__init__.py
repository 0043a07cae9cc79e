"""The model substrate: a decoder transformer, the serving subset."""
from repro_torch.models.api import Model, build_model  # noqa: F401
