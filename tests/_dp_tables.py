"""DP jobs for the port's batcher tests, as the JobTable that a batcher's
run_table takes."""

import numpy as np

from mtr_tpu_torch.pipeline import MODES, JobTable, unit_table


def dp_table(jobs) -> JobTable:
    """One table row a job, in order and not deduplicated: jobs are
    (read, qs, qe, unit codes, scheme, mode) tuples, read an index into
    the reads that the batcher's begin_batch took."""
    units = [np.asarray(job[3], np.int32) for job in jobs]
    codes, ulens = unit_table(np.concatenate(units),
                              np.array([len(u) for u in units], np.int64))
    read, qs, qe = (np.array([job[i] for job in jobs], np.int64)
                    for i in range(3))
    return JobTable(read, qs, qe, np.arange(len(jobs)),
                    np.array([job[4] for job in jobs], np.int32),
                    np.array([MODES.index(job[5]) for job in jobs], np.int32),
                    codes, ulens)
