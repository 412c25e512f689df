"""The paper's federated models (only the FEMNIST CNN so far)."""

from repro_torch.models.small import (FEMNIST_CNN, SMALL_MODELS,
                                      SmallModelSpec, params_from_reference)

__all__ = ["FEMNIST_CNN", "SMALL_MODELS", "SmallModelSpec",
           "params_from_reference"]
