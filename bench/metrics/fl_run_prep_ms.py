"""FL entry (`fl/trainer.run_fl`): host time per round that a run spends
before it first reaches the card (the synthetic data, the round plan,
the initial parameters made on the host), spread over the run's rounds:
the start of the stretch's first device record, which is the copy of
the run's first tensor to the card, counted from the call's start."""


def read(td):
    if not td.device_ops or not td.rounds:
        return None
    return td.device_ops[0][1] / 1e3 / td.rounds
