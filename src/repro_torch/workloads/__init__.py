from repro_torch.workloads.patterns import WORKLOADS, Workload, get_workload
