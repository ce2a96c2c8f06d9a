from repro_torch.models import (attention, layers, mla, model, moe,
                                ssm, transformer)
from repro_torch.models.model import Model
