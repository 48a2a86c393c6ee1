"""launch_ms.restormer: mean host milliseconds to issue one Restormer
forward, outside the CUDA runtime's calls: the program's
``restormer.forward`` spans in the traced window less the time the
launching thread spent inside CUDA calls during each
(``harness.launches.host_ms_outside_runtime``).  At this cell's load the
card's launch queue is full and a launch blocks, so the span itself
follows the card's pace; this reads the host's own launch cost, which
fewer or cheaper launches move.  Nothing untraced, or where the program
recorded no such span."""
from port_bench.harness import launches


def read(run):
    return launches.host_ms_outside_runtime(run, "restormer.forward")
