"""The Monte-Carlo workloads of the port's chip runs, defined once:
``chip_smoke.py`` drives and gates them, ``profile_cells.py`` profiles them.
Plain constants, so that ``profile_cells.py`` also runs against an earlier
tree of the port.  All at batch 2048, 8 chunks per host fetch."""

BATCH = 2048
STEPS_PER_CALL = 8

# the headline: the reference's [[610,61]] code, weight-15 Pauli errors,
# p = 0.01, at most 100 iterations, 64 chunks (bench.py:172-207)
HEADLINE_CODE = (4, 5, 10, 61, 9, 49)  # construct_code(J, K, L, P, sigma, tau)
WEIGHT = 15
P_ERR = 0.01
MAX_ITERS = 100
CHUNKS = 64

# the relay setting of benchmarks/data/relay_tuning_r4.jsonl line 6
RELAY_WEIGHT = 40
RELAY_P = 0.02
RELAY_RETRIES = 16
RELAY_CHUNKS = 8

# bench.py's bicycle_gross line: the gross code, depolarizing p = 0.01,
# 100 iterations (min-sum checks every 10), CHUNKS chunks
GROSS = "[[144,12,12]]"
GROSS_P = 0.01
GROSS_RELAY_P = 0.03
GROSS_RELAY_RETRIES = 8
GROSS_RELAY_CHUNKS = 4
