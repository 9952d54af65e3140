"""The benchmark's harness: registry, graphs, traffic, spans and traces."""
