"""The card's peaks and a kernel's least time: a frozen copy of chip_smoke.py's
arithmetic (PEAK_BYTES_S, ISSUE_OPS_S, ALU_OPS_S, the OPS_* counts, bound_ms
and ops_of).

H100 SXM peaks from NVIDIA's data sheet, at the full power limit of 700 W:
HBM3 at 3.35 TB/s, and 67 TFLOP/s in f32 outside the tensor cores, which
counts a fused multiply-add as two operations. The port's kernels are built
with -fmad=false, so each f32 add or multiply is one instruction of the FMA
pipe: 33.5e12 a second (132 SMs x 128 lanes x 1.98 GHz). Integer
operations, compares, min/max, selects and conversions run on the ALU pipe,
which has 64 lanes per SM, half that rate. All instructions share the
128-lane issue, so the operation floor is the larger of (fma + alu) /
ISSUE_OPS_S and alu / ALU_OPS_S. A card set below 700 W runs slower; the
benchmark prints the card's power limit beside every share of these peaks.
"""

PEAK_BYTES_S = 3.35e12
ISSUE_OPS_S = 67e12 / 2
ALU_OPS_S = ISSUE_OPS_S / 2

# operations per unit of work, counted from the kernel bodies as
# (fma-pipe, alu-pipe), the recurrence's own arithmetic (the address
# arithmetic of the gathers and loop control are left out, as work a
# better kernel could amortise):
# score_fill, per cell: compares q == r, r < 4, two selects for s, the add,
#   the floor at 0 and the running best
OPS_SCORE_CELL = (0, 7)
# corridor_windows, per problem and wavefront: the two counts (a mark and
# a scan add each), the window height and its running max; per row, the two
# keys (conversion, subtract, divide ~10 FMA-pipe instructions as
# __fdiv_rn expands, convert back; clamps, max, add: 8 ALU each)
OPS_WINDOW_STEP = (0, 6)
OPS_WINDOW_ROW = (20, 16)
# convex_fill, per live cell, as the tiled kernel computes it: diag = s2 +
# (mat | mis) (1 add; the code test and a select, 2); the max of three with
# the floor (3); the three tie tests and the two extension tests (5); the
# live test (1); the keep / DEL / INS predicates (4); the run and the score
# selects (3); the per-lane best (3); the direction (3); the value the cell
# offers its neighbours: run * gdecay + ge, + s, + go, run + 1 (5 adds and
# multiplies), the min with gemin, the zero test and its select (3), the
# four up / left selects (4); packing the direction byte (1)
OPS_FILL_CELL = (6, 32)
# convex_backtrack, per walk step, the walk's own tests as the plain
# version makes them: the lane and its bounds (3), the STOP test (1), the
# validPath band (convert, 2 adds + 1 subtract, 2 converts back; 2
# compares), the op's pack (2), the two moves (6), the edge test (2) and
# the step's wavefront test (2)
OPS_WALK_STEP = (3, 21)
# expand_votes, per vote and binary-search step: the compare and the select
# of the next bound (ceil(log2(SL2 + 1)) = 10 steps for 544 slots)
OPS_EXPAND_STEP = (0, 2)


def bound_ms(nbytes, ops):
    """(least ms, "bytes" or "operations") for nbytes of traffic and ops =
    (fma-pipe, alu-pipe) operation counts."""
    fma, alu = ops
    b = nbytes / PEAK_BYTES_S * 1e3
    o = max((fma + alu) / ISSUE_OPS_S, alu / ALU_OPS_S) * 1e3
    return max(b, o), ("bytes" if b >= o else "operations")


def ops_of(per_unit, n):
    return tuple(k * n for k in per_unit)
