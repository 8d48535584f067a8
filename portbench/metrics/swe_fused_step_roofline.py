"""The fused SWE step's share of its roofline in the traced slice (%): the
bound time of every ``swe_fused_step_kernel`` launch (its bytes at the HBM
peak, counted from its batch and grid by ``portbench.counts.swe``) over the
launches' device time.  The launch's grid gives the batch (z) and, through
the configuration's grids, the level (x tiles of 32 cells)."""
from portbench.counts.swe import fused_step_bound_s


def read(facts, trace):
    if trace is None:
        return None
    bound = spent = 0.0
    for op in trace.kernels("swe_fused_step_kernel"):
        grid = op.args.get("grid")
        if not grid or op.dur <= 0:
            continue
        ny, nx = facts["grids"][str(int(grid[0]))]
        bound += fused_step_bound_s(int(grid[2]), ny, nx, facts.get("n_probes", 2))
        spent += op.dur * 1e-6
    return 100.0 * bound / spent if spent > 0 else None
