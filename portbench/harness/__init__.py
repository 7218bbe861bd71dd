"""The harness: spec, traffic, program, loops, trace, check, readings."""
