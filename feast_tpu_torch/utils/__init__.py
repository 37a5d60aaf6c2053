from . import diagnostics, tracing
from .diagnostics import (PhaseTimer, convergence_info, filter_quality,
                          print_convergence_info)
