"""The port's simulators: network models, the paper's batch protocol,
the event-driven cluster simulator and its scenario presets."""
