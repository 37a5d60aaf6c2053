from .feast import (DualFeastResult, FeastResult, clear_graph_cache,
                    dual_gen_feast, feast, feast_compiled, gen_feast)
from .ifeast import feast_iterative, ifeast
from .nlfeast import (NlfeastResult, beyn_qr_extract, beyn_rr2_extract,
                      beyn_rr_extract, beyn_svd_extract, nlfeast, nlfeast_it,
                      nlfeast_moments)
from .beyn import BeynResult, beyn, block_ss
from .companion import CompanionResult, companion
from .stochastic import contour_estimate_eig
from .nlfeast_experimental import nlfeast_moments_all, nlfeast_moments_ss, nlfeast_rr
