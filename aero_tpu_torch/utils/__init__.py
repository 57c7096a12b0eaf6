from .tracing import span, get_tracer, Tracer, TraceRecord
