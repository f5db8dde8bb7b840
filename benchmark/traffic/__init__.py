"""The one traffic generator and the traffic mixes it reads (one JSON file
each: `<name>.json`)."""
