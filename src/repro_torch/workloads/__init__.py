from repro_torch.workloads.patterns import WORKLOADS, Workload, get_workload
from repro_torch.workloads.arrivals import (JobSpec, burst_stream,
                                            mixed_size_factory,
                                            poisson_stream, replicated,
                                            serial_stream)
