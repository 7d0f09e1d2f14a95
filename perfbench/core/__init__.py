"""The benchmark's yardstick: cell lookup, traffic, weights, FLOP and byte
counts, profiler arithmetic, comparisons and the result line. Later cells
reuse it unchanged; what belongs to one cell lives in its own files."""
