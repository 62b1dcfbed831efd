"""The 90th percentile of the window's step times, in ms: a step is the host clock
from one step's feed call to the next one's (each step ends in a synchronising
``float(loss)``), the last step's to the window's end.  Percentile by linear
interpolation between the closest ranks; every step of the window, no chunking."""

import numpy as np


def read(run):
    return float(np.percentile(run.step_s, 90)) * 1e3
