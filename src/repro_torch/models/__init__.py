from repro_torch.models import attention, layers, model, transformer
from repro_torch.models.model import Model
