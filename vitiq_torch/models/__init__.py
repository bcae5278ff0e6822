"""Model modules: layers, embeddings, encoder and the AMC classifier."""

from vitiq_torch.models.amc import AMCModel  # noqa: F401
