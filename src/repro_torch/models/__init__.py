from repro_torch.models.config import LMConfig
from repro_torch.models.lm import LM
