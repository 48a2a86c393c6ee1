"""The figures' edge.  matplotlib (and, for the error boxes, seaborn and
pandas) are imported only to draw a figure, where they are installed;
elsewhere the command has written its tables already and says on stderr
which figure it did not draw.  No other module of the port imports them.
"""

import importlib
import pathlib
import sys


def plotting(command: str, outfile, *modules: str):
    """``(matplotlib, *modules)``: matplotlib on its Agg backend, then each
    module named (``"matplotlib.pyplot"``, ``"seaborn"``, ...), imported to
    draw ``outfile``.  Where one of them is not installed: None, after one
    line on stderr, ``<command>: <package> is not installed; <file> not
    drawn``."""
    name = "matplotlib"
    try:
        matplotlib = importlib.import_module(name)
        matplotlib.use("Agg")
        out = [matplotlib]
        for name in modules:
            out.append(importlib.import_module(name))
    except ImportError:
        print(f"{command}: {name.split('.')[0]} is not installed; "
              f"{pathlib.Path(outfile).name} not drawn", file=sys.stderr)
        return None
    return tuple(out)
