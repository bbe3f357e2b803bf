"""Constants shared between the device combine greedy (ops/combine_greedy)
and its packer (parallel/combine_device_greedy). Values equal the JAX
package's, so both packages pack, flag and dispatch alike."""

SCALE = 1 << 20          # rational-key fraction scale (ops/combine_greedy)
NMAX = 1024              # max group size for key exactness
CMM_MAX = 1023           # max combine_match_max for key exactness
SPAN_MAX = 1 << 18       # max local coordinate / |svlen| (int32 budget)
EPS = 1e-5               # float32-vs-float64 ambiguity margin

# per-segment flag bits for the whole-task grid greedy
SEGF_AMBIGUOUS, SEGF_ED_MISS, SEGF_N_OVERFLOW = 1, 2, 4

# potential-head ED table depth per segment (grid greedy)
TASK_ED_HEADS = 8

# per-segment candidate cap for the grid greedy
SEG_LMAX = 2048

# device-vs-host dispatch threshold for edit-distance batches, in DP
# cells (ops/edit_distance_batch.DEVICE_MIN_CELLS asserts they stay
# equal). A cell count, kept equal to the JAX package's so both packages
# send the same batches to the device.
ED_DEVICE_MIN_CELLS = 2 * 10 ** 8
