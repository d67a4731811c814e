"""The LMs for training and serving: layers, attention, MoE, the decoder
stack, the model and the weights carried across from and to the JAX
package's trees."""
