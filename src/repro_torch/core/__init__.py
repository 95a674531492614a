"""Planning, policies and the online controller (framework-free copies of ``repro.core``)."""
