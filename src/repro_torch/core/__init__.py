"""Core contribution of the paper: C2P2SL scheduling + joint optimization
(numpy and scipy on the host; port of the JAX package's ``repro.core``)."""
from repro_torch.core.costs import LayerProfile, lm_profile, resnet18_profile
from repro_torch.core.schedule import (Plan, TaskTimes, bubble_rate,
                                       simulate_c2p2sl, simulate_epsl,
                                       simulate_psl, simulate_sl,
                                       steady_state_ok, task_times)
from repro_torch.core.ao import AOResult, algorithm1, lemma1_k
