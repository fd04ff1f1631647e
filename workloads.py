"""The Monte-Carlo workloads of the port's chip runs, defined once:
``chip_smoke.py`` drives and gates them, ``profile_cells.py`` profiles them.
Plain constants, so that ``profile_cells.py`` also runs against an earlier
tree of the port.  At batch 2048, 8 chunks per host fetch, except the OSD
quality mode, which reads the host once per chunk by design."""

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

# the OSD quality mode, min-sum + device OSD-0 (K7) at ler_sweep.py's
# settings: [[610,61]], W = 40, p = 0.02, at most 100 iterations, check every
# 10, batch 16,384 (benchmarks/results/quality_sweep_r5.jsonl line 10)
OSD_WEIGHT = 40
OSD_P = 0.02
OSD_BATCH = 16384
OSD_CHUNKS = 8
OSD_LAM = 0

# the host-OSD quality stacks: layered min-sum + relay 12 + OSD-60 on
# [[610,61]] at W = 40 (quality_sweep_r5.jsonl line 5), and the gross code,
# min-sum + relay 8 + OSD-20, depolarizing p = 0.05
# (benchmarks/results/bicycle_gross_r2.jsonl line 10)
QUALITY_RELAY = 12
QUALITY_LAM = 60
QUALITY_CHUNKS = 16
GROSS_QUALITY_P = 0.05
GROSS_QUALITY_RELAY = 8
GROSS_QUALITY_LAM = 20
GROSS_QUALITY_CHUNKS = 8
