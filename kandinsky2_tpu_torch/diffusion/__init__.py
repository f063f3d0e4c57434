from . import schedules
from .gaussian import (
    MeanType,
    Schedule,
    VarType,
    extract,
    make_schedule,
    p_mean_variance,
    predict_xstart_from_eps,
)
from .samplers import DDIMTables, ddim_loop, make_ddim_tables, p_sample_loop
