"""Monte-Carlo drivers (PyTorch), the OSD quality mode included, and the
multi-device engines: the (data, graph) mesh, data-parallel runs and the
graph-sharded engines: block columns of circulant codes, lift-group lanes
of lifted codes."""

from qec_ldpc_tpu_torch.parallel.graph_sharded import make_graph_sharded_decoder
from qec_ldpc_tpu_torch.parallel.lifted_sharded import make_lifted_sharded_decoder
from qec_ldpc_tpu_torch.parallel.mc_graph import (
    make_graph_sharded_arrays_chunk,
    make_graph_sharded_chunk,
    make_graph_sharded_osd_chunk,
)
from qec_ldpc_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    GRAPH_AXIS,
    Mesh,
    make_mesh,
    maybe_init_distributed,
    spawn,
)
from qec_ldpc_tpu_torch.parallel.montecarlo import (
    effective_steps_per_call,
    make_osd_chunk,
    make_sharded_chunk,
    mc_chunk,
    mc_chunk_arrays,
    run_monte_carlo,
    run_monte_carlo_osd,
)
