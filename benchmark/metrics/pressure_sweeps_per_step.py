"""Red-black sweeps per step of the pressure solve with an early exit:
the program's device counter of the chunks the solve ran
(``PoissonSolver.chunks_run``), read before and after the traced chunks,
times the sweeps per chunk, over the steps traced."""

LAYER = "pressure solve"
UNIT = "sweeps"
MOVES = "cell_updates_per_s"
WORKLOADS = ["cylinder600x180.rbsor"]


def read(record):
    before, after = record.counters.get("before"), record.counters.get("after")
    if not before or not after or record.steps <= 0:
        return None
    chunks = after["poisson_chunks_run"] - before["poisson_chunks_run"]
    return chunks * after["poisson_check_every"] / record.steps
