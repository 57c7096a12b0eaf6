from . import cairo_memory
