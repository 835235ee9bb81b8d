"""Traffic drivers: one module a traffic kind (a traffic file's "kind").

A driver module defines `Driver(ctx)` with:

- `row_order`: "scan" when its output rows follow the scan's own row
  order, "channel" when they follow its stable sort by channel;
- `growths`: the capacities it grew in set-up;
- `warm()`: run every shape the traffic uses once, growing capacities as
  the program's own loop grows them, so that no compile, build or growth
  falls into the window;
- `unit()`: one unit of the traffic's work on the program's entry, host
  arrays in and out: {"frames": pool indices, "rows": each frame's output
  rows (M, 5: x, y, z, intensity, label) or None, "stats": each frame's
  (num_attenuated, num_removed, avg_intensity_diff), "failed": frames
  that failed, "latencies": seconds of each call, or empty}.

The seed of a frame's RANSAC draws follows the traffic's "draws"
(`port_bench/inputs.draws_seed`).
"""
