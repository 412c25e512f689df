"""The whole round: model FLOPs of the timed window's rounds (forward and
backward of every silo's batch, `yardstick.round_flops`) over the
window's wall time and the card's fp32 peak, in %. TF32 is off in the
program, so fp32 is the arithmetic that runs."""


def read(td):
    if td.window_round_ms <= 0:
        return None
    return 100.0 * td.round_flops / (td.window_round_ms / 1e3) \
        / td.peak_flops
