"""Model zoo of the port: attention ("attn"/"swa"/"shared_attn"), MoE
("moe") and Mamba-2 ("mamba2") blocks, and the audio/vision frontend
stub; the xLSTM blocks ("mlstm"/"slstm") come with a later slice."""
