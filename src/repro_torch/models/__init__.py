"""The paper's federated models: the FEMNIST CNN, the Sent140 LSTM and
the iNaturalist ResNet."""

from repro_torch.models.small import (FEMNIST_CNN, INAT_RESNET, SENT140_LSTM,
                                      SMALL_MODELS, SmallModelSpec,
                                      param_count, params_from_reference)

__all__ = ["FEMNIST_CNN", "INAT_RESNET", "SENT140_LSTM", "SMALL_MODELS",
           "SmallModelSpec", "param_count", "params_from_reference"]
