from .tracing import (count, span, get_tracer, subtree, subtree_count,
                      Tracer, TraceRecord)
