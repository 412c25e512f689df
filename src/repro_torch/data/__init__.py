"""Synthetic federated datasets."""

from repro_torch.data.synthetic import (FederatedDataset,
                                        make_federated_dataset,
                                        make_lm_dataset)

__all__ = ["FederatedDataset", "make_federated_dataset", "make_lm_dataset"]
