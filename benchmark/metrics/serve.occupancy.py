"""serve.occupancy: mean requests a batch of the window (the batcher's
``on_batch``)."""


def read(obs):
    occupancy = obs.get('occupancy')
    return sum(occupancy) / len(occupancy) if occupancy else None
