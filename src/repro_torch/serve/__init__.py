from repro_torch.serve import engine, paged_cache, queue, telemetry
from repro_torch.serve.engine import Engine, ServeConfig, SpecConfig
from repro_torch.serve.queue import Request, RequestQueue
from repro_torch.serve.telemetry import RequestTelemetry, ServeReport
