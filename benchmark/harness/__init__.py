"""The benchmark's yardstick: window timing, the result line, trace
reduction, work counts, weights and inputs made from the seed."""
