"""The plain references, one module per family of configurations, named by
a configuration's ``reference`` key. Each imports torch only."""
