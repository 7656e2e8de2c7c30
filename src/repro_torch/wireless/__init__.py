"""The paper's TDMA channel and UE fleet (port of ``repro.wireless``)."""
from repro_torch.wireless.channel import (BandwidthTrace, ChannelParams,
                                          LinkShaper, bandwidth_step_trace,
                                          pathloss_db, shannon_rate,
                                          shannon_trace, ue_rates)
from repro_torch.wireless.fleet import (UE, Fleet, sample_fleet, BS_FLOPS,
                                        K_UE, K_BS, F_BS)
