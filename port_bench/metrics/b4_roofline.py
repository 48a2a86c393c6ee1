"""b4_roofline: kernel B4's share of its roofline in the traced window:
the summed bounds of its launches over their summed device time.  The
launches are the trace's ``gdfn_gate_kernel`` kernels, one for the gated
FFN of each of the 44 transformer blocks of a full-batch Restormer
forward; nothing when there are none (a program without B4), or when
their count is not a whole number of forwards.

A launch's bound is its bytes over the card's bandwidth (B4 does 18 FMAs
and an erff an output against 12 bytes, under the ridge): the 2h planes
of the block's ``project_in`` output read once, the h gated planes
written once and the 9 taps of each of the 2h channels, 4 bytes each.
The blocks' widths and plane sides come from the configuration's
``dim``, ``num_blocks``, ``num_refinement_blocks`` and
``ffn_expansion_factor`` (h = int(width * factor)), at the traffic's
batch and centre crop."""
import re

B4 = re.compile(r"\bgdfn_gate_kernel\b")


def blocks(side: int, cfg: dict) -> list:
    """(h, H) of the gated FFN of every block of one forward on a side x
    side image, in launch order: the encoders and the latent, decoders 3
    and 2 at their levels' widths, then decoder 1 and the refinement at
    twice the first level's width and the full side."""
    dim, f, nb = cfg["dim"], cfg["ffn_expansion_factor"], cfg["num_blocks"]
    out = []
    for level in (0, 1, 2, 3, 2, 1):
        out += [(int(dim * 2 ** level * f), side >> level)] * nb[level]
    return out + [(int(2 * dim * f), side)] * (
        nb[0] + cfg["num_refinement_blocks"])


def forward_bytes(batch: int, side: int, cfg: dict) -> int:
    """The summed bytes of B4's launches in one forward."""
    return sum(4 * (batch * 3 * h * H * H + 2 * h * 9)
               for h, H in blocks(side, cfg))


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    times = [s for name, s in run.trace.kernels if B4.search(name)]
    side = min(run.traffic["side"], 512)
    n = len(blocks(side, run.config))
    if not times or len(times) % n:
        return None
    bound = forward_bytes(run.traffic["batch_size"], side, run.config) / \
        run.peaks["bytes_per_s"]
    return 100.0 * bound * (len(times) // n) / sum(times)
