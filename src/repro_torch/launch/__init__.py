"""Entry points: the train, prefill and serve step builders (`steps`),
the reduced LLM federated trainer (`train`), the silo axis (`mesh`) and
the eight-silo ring gossip round (`fl8`)."""

from repro_torch.launch.mesh import GroupSilos, StackedSilos

__all__ = ["GroupSilos", "StackedSilos"]
