"""Entries into the port, one module a way of driving it. Each has
``setup(ctx) -> state`` (weights, inputs, the port's objects, a warm-up of the
cell's shapes), ``window(ctx, state) -> {"images", "counters", "notes"}`` (the
measured work; it returns when ``ctx.seconds`` have passed and the work in
flight is done) and ``check(ctx, state, window) -> (checks, attempted,
failed)``, where each check is ``{"name", "value", "limit"}`` and holds when
value <= limit."""
