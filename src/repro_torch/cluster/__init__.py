"""The cluster layer of the port: nodes, heartbeats, failure models and
the FANS scheduler, whose placements run on the port's engine."""
