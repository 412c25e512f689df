"""Entry points: the train, prefill and serve step builders (`steps`),
the reduced LLM federated trainer (`train`), the silo axis (`mesh`), the
eight-silo ring gossip round (`fl8`), and the launch analysis tools on
the host: input shapes (`specs`), the analytic roofline (`roofline`),
the fake-tensor dry run (`dryrun`) and its perf variants (`perf`)."""

from repro_torch.launch.mesh import GroupSilos, StackedSilos

__all__ = ["GroupSilos", "StackedSilos"]
