from . import mesh, rowsharded, slicing
from .mesh import (node_mesh, node_row_mesh, replicate, row_sharded_qr,
                   shard_nodes, shard_rows)
from .rowsharded import feast_iterative_rows, partition_csr
from .slicing import (feast_sliced, feast_sliced_parallel, spectral_slices,
                      SliceResult)
