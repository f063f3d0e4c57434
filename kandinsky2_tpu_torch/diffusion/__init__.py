from . import schedules
from .gaussian import (
    LossType,
    MeanType,
    Schedule,
    VarType,
    extract,
    make_schedule,
    p_mean_variance,
    predict_xstart_from_eps,
    q_sample,
    training_losses,
)
from .samplers import DDIMTables, ddim_loop, make_ddim_tables, p_sample_loop
