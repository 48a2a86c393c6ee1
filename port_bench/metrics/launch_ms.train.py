"""launch_ms.train: mean host milliseconds of one training step's call,
from the program's ``train.step`` spans in the traced window
(``harness.program``): the time the host takes to launch a step's
forward, backward and AdamW, against the card's time to run them;
nothing untraced, or where the program recorded none."""
from port_bench.harness import program


def read(run):
    return program.mean_ms(run, "train.step")
