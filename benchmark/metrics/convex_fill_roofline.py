"""convex_fill's share of its roofline in the window: the least time the
card needs for the window's useful fill cells (pipeline.ctx.stats
cells_align_useful: sum of qlen * min(width, W) over the align problems),
at OPS_FILL_CELL operations and one direction byte written per cell
(harness/peaks.py, H100 SXM peaks), over the fill kernels' device seconds
in the window (fill_tiled, fill_wide; torch.profiler)."""

KERNELS = ("fill_tiled", "fill_wide")


def read(run):
    if run.trace is None:
        return None
    dev_s = run.trace.seconds_of(*KERNELS)
    cells = run.delta("cells_align_useful")
    if dev_s <= 0 or cells <= 0:
        return None
    p = run.peaks
    least_ms, _ = p.bound_ms(cells, p.ops_of(p.OPS_FILL_CELL, cells))
    return 100.0 * least_ms / 1e3 / dev_s
