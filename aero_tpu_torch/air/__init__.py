from .air import Air, Assertion, TransitionDegree
