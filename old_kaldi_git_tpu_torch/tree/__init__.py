"""Phonetic-context decision trees: the EventMap hierarchy and
ContextDependency, as the training-graph compiler reads them."""
