"""Plain PyTorch reference of what the benchmark judges. It imports
nothing of the program: each function follows the published method (and,
where the method leaves a choice to the implementation, the program's
documented rule, restated here) in float64, with no kernel, cache or
batching of the program's."""
