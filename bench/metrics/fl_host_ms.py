"""FL entry and round loop (`fl/trainer._train_flat`): host time per
round outside the device's dispatches, from the program's own recorder
spans. From the recorder's epoch, which the trainer sets after the run's
data, plan and initial parameters are made, to the end of its last
`eval` span, less the `dispatch` and `compile+dispatch` spans: round
sampling, staging to the card and the evaluations."""


def read(td):
    spans = td.host_spans
    ends = [e for name, _, e in spans if name == "eval"]
    if not ends or not td.rounds:
        return None
    last = max(ends)
    dispatch = sum(e - s for name, s, e in spans
                   if name in ("dispatch", "compile+dispatch") and e <= last)
    return (last - dispatch) / 1e3 / td.rounds
