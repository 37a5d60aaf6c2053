from .feast import FeastResult, dual_gen_feast, feast, feast_compiled, gen_feast
from .ifeast import feast_iterative, ifeast
