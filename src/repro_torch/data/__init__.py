"""Data pipelines. Port of ``repro/data``: the synthetic LM stream and the
cluster traces the simulator replays."""
from repro_torch.data.synthetic import SyntheticLM, input_specs, to_torch
from repro_torch.data.trace import (SCALE_PRESETS, Incident,
                                    ReliabilityConfig, StreamTrace, Trace,
                                    TraceConfig, TraceJob, TraceReader,
                                    TraceTail, hazard_per_day, horizon,
                                    install_stream, mtbf_days, read_tail,
                                    scale_preset, synthesize,
                                    synthesize_stream, write_trace)
