"""One driver a kind of traffic (the `driver` key of a traffic file)."""
